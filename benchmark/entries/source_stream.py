"""Entry `source_stream`: `Receiver.process_stream`'s conditioned tracking
half, from the source's raw items at the source's own rate.

The deployment's front end is the program's, built from the
configuration's `source_keys` (`runtime.config.build_frontend`, the keys
the conf gives the SignalConditioner) and run by the program's
`runtime.stream.StreamFrontEnd`.  The capture's raw items lie in ordinary
host memory, as a file or socket source hands them over.  For each 1 s
segment (25 blocks of 40 ms and the epoch tail) `PinnedStaging.upload`
stages the segment's (span + nmax) D source items in pinned memory and
copies them to the card, where the front end decodes, filters,
decimates, rotates and scales them in one launch, its history and mixer
phase carried from the segment before; `TrackingEngine.launch_capture`
enqueues the conditioned segment and queues its per-epoch rows' copy to
pinned memory.  Segment k+1 is launched before segment k is harvested
(`harvest_capture`), as process_stream does.  A pass walks the capture's
segments from the truth's activation state, the front end started anew;
passes follow one another in the same pipeline until the window closes.

The capture: the harness's satellites (`ctx.sats`) generated at the
source rate on the card in 1 s blocks (`gnssbench.signal`'s generator),
the time origin advanced by the FIR's group delay, (n_taps - 1) / 2
source samples, so that the conditioned stream's sample m lies at the
truth's time m / fs and the harness's truth and activation state hold for
it.  A real IF source (nsr) is then mixed up to the IF, its real part
quantised to the 2-bit code at thresholds 0 and +-`nsr_threshold_sigma`
noise sigmas and packed four samples a byte, the least significant pair
first; an ishort source is rounded as the harness rounds its own.  The
ingest scale is the receiver's, taken from the reference's conditioned
head.

A segment's latency runs from its upload call to its harvest's return
(rows on the host).  Spans: ingest (upload + front end), launch
(launch_capture), readback (harvest_capture).  The traced run also keeps
the device time of the front end's kernels (by name, from the profiler's
trace) and each traced segment's conditioning work for
`condition_roofline`, and the window's front-end launches for
`condition_launches_per_s`.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
from gnss_sdr_1_tpu_torch.ops import xlate_fir
from gnss_sdr_1_tpu_torch.runtime.config import (InMemoryConfiguration,
                                                 build_frontend)
from gnss_sdr_1_tpu_torch.runtime.stream import PinnedStaging, StreamFrontEnd

from gnssbench import check
from gnssbench import signal as sig
from gnssbench.reference import front_end as ref_fe
from gnssbench.roofline_front_end import kernel_seconds

# the front end's kernel, as the profiler names it
KERNEL = "xlate_fir_kernel"


def advanced(sat: sig.Sat, t0: float, fc: float, rate: float) -> sig.Sat:
    """The satellite seen t0 seconds later: sat'(t) = sat(t + t0) under the
    generator's model (code, symbols and carrier with Doppler and Doppler
    rate)."""
    fd, r = sat.doppler_hz, sat.doppler_rate_hz_s
    dil = fd * t0 + 0.5 * r * t0 * t0
    return sig.Sat(prn=sat.prn, doppler_hz=fd + r * t0,
                   doppler_rate_hz_s=r,
                   delay_chips=sat.delay_chips - rate * (t0 + dil / fc),
                   cn0_dbhz=sat.cn0_dbhz, nav_bits=sat.nav_bits,
                   phase_rad=float(np.mod(sat.phase_rad + 2.0 * np.pi * dil,
                                          2.0 * np.pi)))


def _block_seed(seed: int, b: int) -> int:
    return int(np.random.SeedSequence([seed, 20, b]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _to_nsr(x: torch.Tensor, first: int, if_hz: float, fs: float,
            threshold: float) -> np.ndarray:
    """A complex baseband block (source samples first, first + 1, ...)
    mixed up to the IF, its real part quantised to the 2-bit code
    (-2, -1, 0, 1 at thresholds -t, 0, t of the real part's noise sigma,
    sqrt(1/2) for unit-variance complex noise) and packed four a byte,
    the least significant pair first."""
    dev = x.device
    base = float(np.mod(if_hz / fs * float(first), 1.0))
    n = torch.arange(x.shape[0], dtype=torch.float64, device=dev)
    ang = 2.0 * np.pi * torch.remainder(base + (if_hz / fs) * n, 1.0)
    real = x.real.double() * torch.cos(ang) - x.imag.double() * torch.sin(ang)
    q = torch.clamp(torch.floor(real / (threshold * np.sqrt(0.5))), -2, 1)
    q = (q.to(torch.int32) & 3).reshape(-1, 4)
    b = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
    return b.to(torch.uint8).cpu().numpy()


def make_source(ctx) -> np.ndarray:
    """The capture's raw items at the source rate, on the host."""
    cfg, plan = ctx.cell.config, ctx.plan
    fs = plan.fs_hz
    n_src = (ctx.n_seg * ctx.span + ctx.nmax) * plan.decim
    shift = (plan.n_taps - 1) / 2.0 / fs
    codes = {p: c for p, c in zip(cfg["prns"], ctx.codes)}
    s = ctx.signal
    block = int(round(fs))
    parts = []
    for b, a in enumerate(range(0, n_src, block)):
        m = min(block, n_src - a)
        sats = [advanced(sat, a / fs + shift, s["carrier_freq_hz"],
                         s["code_rate_chips_s"]) for sat in ctx.sats]
        x = sig.generate_on_card(s, sats, codes, fs, m / fs, ctx.device,
                                 _block_seed(ctx.seed, b))
        if plan.fmt == "nsr":
            parts.append(_to_nsr(x, a, plan.if_hz, fs,
                                 float(cfg["nsr_threshold_sigma"])))
        else:
            parts.append(sig.to_ishort(x, float(cfg["ishort_scale"])))
        del x
    return np.concatenate(parts)


def prepare(ctx) -> None:
    """The program's front end, the source capture and the ingest scale;
    the harness's capture at the internal rate is dropped."""
    cfg = ctx.cell.config
    ctx.capture = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.plan = ref_fe.plan_of(cfg)
    conf = InMemoryConfiguration({k: str(v)
                                  for k, v in cfg["source_keys"].items()})
    ctx.front = StreamFrontEnd(build_frontend(conf), cfg["item_type"],
                               ctx.device)
    if (ctx.front.decim, ctx.front.n_taps) != (ctx.plan.decim,
                                               ctx.plan.n_taps):
        raise ValueError("the program's front end and the reference's "
                         "differ in decimation or taps")
    ctx.items = make_source(ctx)
    ctx.n_out = ctx.span + ctx.nmax
    ctx.n_items = ctx.front.items(ctx.n_out * ctx.plan.decim)
    # the receiver's ingest scale, from the first 2^18 conditioned samples
    head = ref_fe.front_end(ctx.items, ctx.plan, 0, 1 << 18).numpy()
    rms = float(np.sqrt(np.mean(np.abs(head) ** 2)))
    ctx.scale = float(np.float32(1.0 / rms))
    ctx.staging = PinnedStaging(ctx.device)


def _ingest(ctx, k):
    a = ctx.front.items(k * ctx.span * ctx.plan.decim)
    raw = ctx.staging.upload(ctx.items[a:a + ctx.n_items])
    return ctx.front.condition(raw, ctx.n_out, ctx.span, ctx.scale)


def warm_up(ctx) -> None:
    """The mix's `warmup_segments` segments through the pipeline (three
    fill both staging buffers and the pinned readback buffers the steady
    state reuses)."""
    eng, state, pending = ctx.engine, ctx.init_state, []
    ctx.front.reset()
    for k in range(int(ctx.cell.mix["warmup_segments"])):
        state, rb = eng.launch_capture(_ingest(ctx, k), state, ctx.span)
        pending.append(rb)
        if len(pending) > 1:
            eng.harvest_capture(pending.pop(0))
    while pending:
        eng.harvest_capture(pending.pop(0))
    ctx.front.reset()


def _keep_kernel_time(ctx, tracer) -> None:
    """In a traced run: the device time of the front end's kernels in the
    trace, read as the tracer stops (its profile is dropped after)."""
    if not tracer.enabled:
        return
    stop = tracer._stop

    def stop_and_read():
        prof = tracer.prof
        stop()
        ctx.cond_device_s = kernel_seconds(prof, KERNEL)

    tracer._stop = stop_and_read


def window(ctx, deadline: float, tracer) -> None:
    eng = ctx.engine
    pending = collections.deque()
    ctx.cond_traced = []
    _keep_kernel_time(ctx, tracer)

    def harvest():
        rec, key, st_in, st_out, rb, traced, seg = pending.popleft()
        t = time.perf_counter()
        with tracer.span("harvest_capture"):
            outs = eng.harvest_capture(rb)
        rec["t_rows"] = time.perf_counter()
        rec["readback_s"] = rec["t_rows"] - t
        tracer.end(traced)
        if key in ctx.keep:
            ctx.kept[key] = (st_in, st_out, {
                f: np.array(getattr(outs, f)) for f in outs._fields}, seg)

    launches = xlate_fir.launches
    p = k = 0
    state = ctx.init_state
    while time.perf_counter() < deadline:
        if k == ctx.n_seg:
            p, k, state = p + 1, 0, ctx.init_state
            ctx.front.reset()
        traced = tracer.begin()
        t_hand = time.perf_counter()
        with tracer.span("upload_condition"):
            seg = _ingest(ctx, k)
        t_in = time.perf_counter()
        with tracer.span("launch_capture"):
            st, rb = eng.launch_capture(seg, state, ctx.span)
        t_l = time.perf_counter()
        rec = {"t_hand": t_hand, "ingest_s": t_in - t_hand,
               "launch_s": t_l - t_in}
        ctx.segments.append(rec)
        if traced:
            ctx.cond_traced.append(_work(ctx))
        # a kept segment's conditioned samples stay on the card (the
        # tensor itself, no copy) for the check
        pending.append((rec, (p, k), state, st, rb, traced,
                        seg if (p, k) in ctx.keep else None))
        state, k = st, k + 1
        if len(pending) > 1:
            harvest()
    while pending:
        harvest()
    tracer.finish()
    ctx.cond_launches = xlate_fir.launches - launches


def _work(ctx) -> dict:
    """A segment's conditioning work for the roofline: its outputs, the
    taps, whether the input is complex, and its bytes."""
    raw_bytes = ctx.items[:ctx.n_items].nbytes
    return {"outputs": ctx.n_out, "taps": ctx.plan.n_taps,
            "complex_input": ctx.plan.fmt != "nsr",
            "input_bytes": raw_bytes, "out_bytes": ctx.n_out * 8,
            "tap_bytes": ctx.plan.n_taps * 8}


class Numbers(check.Numbers):
    """The check's numbers and `cond_gap`: the largest difference of a
    compared segment's conditioned samples from the reference's, over the
    reference's RMS, the largest over the segments."""

    def __init__(self):
        super().__init__()
        self.cond = []

    def add_cond(self, got: np.ndarray, want: np.ndarray) -> None:
        rms = float(np.sqrt(np.mean(np.abs(want.astype(np.complex128))
                                    ** 2)))
        self.cond.append(float(np.abs(got.astype(np.complex128)
                                      - want).max()) / rms)

    def values(self) -> dict:
        return {**super().values(), "cond_gap": max(self.cond, default=0.0)}

    def widest(self) -> dict:
        return {**super().widest(), "cond_gap": max(self.cond, default=0.0)}


def compare(ctx, control=None) -> check.Numbers:
    """The kept segments against the reference: the start from the truth,
    then each kept segment's conditioned samples against the reference's
    front end on the same raw items (`cond_gap`), and its per-epoch rows
    and exit state against the reference's walk of the reference's
    conditioned samples, from the reference's own state where it follows a
    kept segment of its pass (`check.walk_from`), else from the state the
    program entered it with.  `control` (a rounding) puts the reference
    at that precision, its front end's products included, in the
    program's place."""
    ref, numbers = check.reference_for(ctx), Numbers()
    check.compare_start(ctx, ref, numbers)
    walkers = {"ref": None} if control is None else {"ref": None,
                                                     "low": control}
    prev = {}                           # walker -> (key, exit rows)
    for key, (st_in, st_out, outs, seg) in sorted(ctx.kept.items()):
        first = key[1] * ctx.span
        n_gap = check.gap_rows(ctx, key, prev.get("ref"))
        walked, conditioned = {}, {}
        for who, lowp in walkers.items():
            x = ref_fe.front_end(ctx.items, ctx.plan, first, ctx.n_out,
                                 ctx.scale, lowp)
            conditioned[who] = x
            rows = check.walk_from(ctx, ref, key, st_in, prev.get(who))
            of, oi, oc, fst2, ist2 = ref.walk(x, *rows, ctx.span, lowp=lowp)
            prev[who] = (key, check.next_rows(fst2, ist2, rows[2], ctx.span))
            walked[who] = (check.rows_outputs(ref, of, oi, oc),
                           check.rows_state(fst2, ist2, ctx.span))
        want, want_state = walked["ref"]
        if control is not None:
            got, got_state = walked["low"]
            got_x = conditioned["low"].numpy()
        else:
            got, got_state = outs, check.state_fields(st_out)
            got_x = seg.cpu().numpy()
        numbers.add_cond(got_x, conditioned["ref"].numpy())
        check.compare_epochs(ref, got, want, numbers, n_gap)
        check.compare_exit(got_state, want_state, ref.t0_int / 2, numbers)
    return numbers
