#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA receiver on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, with times):
  1. the card (nvidia-smi name and power limit) and the kernel build (one
     nvcc for the tracking library), with ptxas' registers, stack frame and
     spills of every kernel instance;
  2. both CUDA kernels against their plain torch versions on the card, at
     the main path's shapes (E=16, LW=68, NW=4136, C=12, K=3), on random
     inputs and on the inputs of a real chunk taken mid-track: the chunk
     correlator (chunk_corr) and the tracking chain (track_chain), each
     timed (device time per launch from the profiler, the plain version,
     and for the correlator the torch.bmm pair it replaces); then the
     capture entry (both kernels over three chunks in one call) against
     the plain chunk loop on the CPU;
  3. batched PCPS acquisition of 12 PRNs (detections, FFTs/s), held to the
     same acquisition run on the CPU;
  4. the tracking engine: 12 channels over a 15 s capture at 4.092 Msps
     (RTF, valid epochs, each kernel's launches == chunks);
  5. the receiver end to end — the main path: 12 satellites, 30 s, live
     LNAV, PVT every 100 ms, the capture preloaded to the card (e2e RTF,
     fixes, median 3D error against the scenario truth, each kernel's
     launches == chunks).
Then one JSON line describing every kernel, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises: the script exits
non-zero and prints no result.  Without a CUDA device it exits non-zero at
once.  Synthetic captures are cached in chip_smoke_cache/ (git-ignored);
the full report (per-row kernel diffs, per-PRN acquisition results) goes to
`--out` (default chip_smoke_cache/) as chip_smoke_report.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FS = 4.092e6
ENGINE_S = 15.0       # engine phase capture (bench.py DURATION_S)
E2E_S = 30.0          # receiver phase capture (bench.py E2E_DURATION_S)
MIN_FIXES = 140
CACHE = ROOT / "chip_smoke_cache"
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# float32 operations per (epoch, channel) of the chain: tap reads ~45,
# rotation ~20, wipe/accumulate ~12, discriminators ~60, PLL ~15, DLL ~30,
# NCO ~15, CN0/lock ~25, ledger ~10, with each transcendental counted as
# ~8 — an estimate; the chain is bound by neither bytes nor operations
OPS_PER_EPOCH_CHANNEL = 300
# float32 operations per wiped sample of the correlator besides the lag
# products: phase (multiply, add), the complex rotation (4 multiplies,
# 2 adds); the sine and cosine are not counted
WIPE_OPS_PER_SAMPLE = 8
# chunks of the capture entry's check in phase 2 (the sample limit of the
# mid-track segment, 40 ms, ends inside the third)
CAPTURE_CHUNKS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=CACHE,
                    help="directory for chip_smoke_report.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import gnss_sdr_1_tpu_torch  # noqa: F401  (sets TF32 off)
    from gnss_sdr_1_tpu_torch.ops import _build
    from gnss_sdr_1_tpu_torch.ops import chunk_corr as cc
    from gnss_sdr_1_tpu_torch.ops import track_chain as tc

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 must be off for the float32 correlations")
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- 1. card + kernel build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"[1] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernel build {build_s:.2f} s (nvcc, "
        f"{' '.join(_build.ARCH_FLAGS)})")
    ptxas = ptxas_report(_build.BUILD_LOG[_build.LIBRARY]["ptxas"])
    for name, r in ptxas.items():
        log(f"    ptxas {name}: {r['registers']} registers, "
            f"{r['stack']} B stack frame, {r['spill_stores']} B spill "
            f"stores, {r['spill_loads']} B spill loads")
    chain_inst = [r for n, r in ptxas.items() if n.startswith("track_chain")]
    if not chain_inst or not any(n.startswith("chunk_corr") for n in ptxas):
        raise AssertionError(f"ptxas report lacks a kernel: {list(ptxas)}")
    for r in chain_inst:
        if r["stack"] or r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"track_chain uses local memory: {r}")

    # ---- 2. kernels vs plain ----
    t0 = time.perf_counter()
    k_rep = phase_kernels(dev, cc, tc)
    cr, ch = k_rep["chunk_corr"], k_rep["track_chain"]
    log(f"[2] chunk_corr vs plain: max |diff| {cr['max_abs_err']:.3e} "
        f"(random {cr['err_random']:.3e} of max|z| {cr['scale_random']:.3e}, "
        f"mid-track {cr['err_track']:.3e} of {cr['scale_track']:.3e}), "
        f"kernel {cr['ms']:.5f} ms/launch device ({cr['ms_host']:.5f} from "
        f"the host), plain {cr['plain_ms']:.3f} ms, torch.bmm pair "
        f"{cr['library_ms']:.5f} ms, bound {cr['bound_ms']:.2e} ms "
        f"({cr['bound_by']})")
    log(f"    track_chain vs plain: max |diff| {ch['max_abs_err']:.3e} "
        f"(random {ch['err_random']:.3e}, mid-track {ch['err_track']:.3e}), "
        f"int rows exact, kernel {ch['ms']:.5f} ms/launch device "
        f"({ch['ms_host']:.5f} from the host), plain {ch['plain_ms']:.3f} "
        f"ms, bound {ch['bound_ms']:.2e} ms ({ch['bound_by']})")
    log(f"    track_capture ({ch['capture_chunks']} chunks, one call) vs the "
        f"plain chunk loop on the CPU: max |diff| {ch['err_capture']:.3e}, "
        f"int rows exact, {ch['capture_valid_epochs']} valid epochs | "
        f"{time.perf_counter() - t0:.1f} s")
    if not cr["ms"] <= cr["library_ms"]:
        raise AssertionError(f"chunk_corr {cr['ms']:.5f} ms is slower than "
                             f"the torch.bmm pair {cr['library_ms']:.5f} ms")

    # ---- 3. acquisition ----
    t0 = time.perf_counter()
    sats, x_eng = engine_capture()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    acq = phase_acquisition(dev, sats, x_eng)
    log(f"[3] acquisition: {acq['detected']}/12 at the true Doppler and "
        f"delay, {acq['ffts_per_s']:.0f} FFTs/s "
        f"({acq['ms_per_call']:.2f} ms/call, F={acq['fft_size']}); against "
        f"the CPU run: same detections and Doppler bins, max delay diff "
        f"{acq['cpu_max_delay_diff']:.3f} samples, max stat rel diff "
        f"{acq['cpu_max_stat_rel']:.2e} | "
        f"{time.perf_counter() - t0:.1f} s (capture made in {gen_s:.1f} s)")

    # ---- 4. engine ----
    t0 = time.perf_counter()
    eng = phase_engine(dev, cc, tc, sats, x_eng)
    del x_eng
    log(f"[4] engine: 12 ch x {eng['signal_s']:.1f} s, RTF "
        f"{eng['rtf']:.2f} ({eng['wall_s']:.3f} s), valid "
        f"{eng['n_valid']}/{eng['expected']:.0f} epochs, launches "
        f"chunk_corr {eng['launches_chunk_corr']} track_chain "
        f"{eng['launches_track_chain']} == chunks {eng['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 5. receiver end to end (the main path) ----
    t0 = time.perf_counter()
    e2e = phase_e2e(dev, cc, tc)
    log(f"[5] receiver e2e: 12 sats x {E2E_S:g} s, RTF {e2e['rtf']:.2f} "
        f"({e2e['wall_s']:.2f} s), fixes {e2e['fixes']}, median 3D error "
        f"{e2e['median_3d_m']:.2f} m, launches chunk_corr "
        f"{e2e['launches_chunk_corr']} track_chain "
        f"{e2e['launches_track_chain']} == chunks {e2e['chunks']} | "
        f"{time.perf_counter() - t0:.1f} s (capture made in "
        f"{e2e['gen_s']:.1f} s)")

    src = "gnss_sdr_1_tpu_torch/csrc/"
    kernels = [{
        "name": "chunk_corr", "route": "cuda",
        "source": src + "chunk_corr.cuh",
        "replaces": "gnss_sdr_1_tpu/track/engine.py:828",
        "launches": e2e["launches_chunk_corr"],
        "max_abs_err": cr["max_abs_err"], "ms": cr["ms"],
        "plain_ms": cr["plain_ms"], "bound_ms": cr["bound_ms"],
        "bound_by": cr["bound_by"], "library_ms": cr["library_ms"],
    }, {
        "name": "track_chain", "route": "cuda",
        "source": src + "track_chain.cu",
        "replaces": "gnss_sdr_1_tpu/ops/pallas_chain.py:503",
        "launches": e2e["launches_track_chain"],
        "max_abs_err": ch["max_abs_err"], "ms": ch["ms"],
        "plain_ms": ch["plain_ms"], "bound_ms": ch["bound_ms"],
        "bound_by": ch["bound_by"], "library_ms": None,
    }]
    report = {"card": smi, "build_s": build_s, "ptxas": ptxas,
              "kernels": k_rep, "acquisition": acq, "engine": eng,
              "e2e": e2e, "total_s": time.perf_counter() - t_all}
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1, default=float))
    log(f"    total {report['total_s']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# phase 1: what ptxas reports
# ---------------------------------------------------------------------------

_KERNEL_NAMES = {"18track_chain_kernel": "track_chain",
                 "17chunk_corr_kernel": "chunk_corr"}


def ptxas_report(text: str) -> dict:
    """Registers, stack frame and spills of every kernel instance in
    `nvcc -Xptxas -v` output, keyed by a readable name (template arguments
    of the chain: K, PLL order, secondary-code data flag, secondary row)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = None
            for mangled, short in _KERNEL_NAMES.items():
                if mangled in m.group(1):
                    args = re.findall(r"L[ib](\d+)E", m.group(1))
                    cur = short + "<" + ",".join(args) + ">"
                    out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            cur = None
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against plain
# ---------------------------------------------------------------------------


def _engine(dev):
    """The engine benchmark's tracker: 12 channels, 16-epoch chunks."""
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine

    codes = np.stack([gps_l1ca_code(p) for p in range(1, 13)])
    cfg = TrackConfig(fs_hz=FS, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=12, chunk_epochs=16)
    return TrackingEngine(cfg, codes, device=dev)


def _bench_sats(duration_s):
    """The engine benchmark's 12 satellites (bench.py scenario, seed 42)."""
    from gnss_sdr_1_tpu_torch.siggen import SatParams

    rng = np.random.default_rng(42)
    return [SatParams(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=44.0,
                      nav_bits=rng.choice([-1.0, 1.0],
                                          size=int(duration_s * 50) + 8))
            for p in range(1, 13)]


def _activate_all(eng, sats):
    st = eng.init_state()
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * FS,
                                  s.doppler_hz, 0, 0)
    return st


def _gen(sats, duration_s, key):
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
    from gnss_sdr_1_tpu_torch.siggen import generate_baseband

    CACHE.mkdir(exist_ok=True)
    path = CACHE / f"{key}.npy"
    if path.exists():
        return np.load(path)
    x = generate_baseband(GPS_L1_CA, sats,
                          {s.prn: gps_l1ca_code(s.prn) for s in sats}, FS,
                          duration_s, noise=True)
    np.save(path, x)
    return x


def _chain_diff(tc, got, want, rows_out=None):
    """Max |diff| of the float outputs, scaled check per row; int rows and
    flags exact.  Raises when a row is over its tolerance.  `rows_out`
    collects (output, row, |diff|, tolerance) per float row."""
    worst = 0.0
    names = ("out_f", "out_i", "out_corr", "fst", "ist")
    for name, g, w in zip(names, got, want):
        g = g.double().cpu()
        w = w.double().cpu()
        if name in ("out_i", "ist"):
            if not torch.equal(g, w):
                raise AssertionError(f"chain kernel int rows differ: {name}")
            continue
        for r in range(g.shape[-2]):
            gr, wr = g[..., r, :], w[..., r, :]
            d = float((gr - wr).abs().max())
            if name == "out_f" and r in (tc.O_VALID, tc.O_ACTIVE):
                if d != 0.0:
                    raise AssertionError(f"chain kernel flag row {r} differs")
                continue
            # float32 rows: atol 1e-4 of the row's scale (the kernel and
            # the plain version round transcendentals and sums differently)
            tol = 1e-4 * max(1.0, float(wr.abs().max()))
            if rows_out is not None:
                rows_out.append((name, r, d, tol))
            if not d <= tol:
                raise AssertionError(
                    f"chain kernel {name} row {r}: |diff| {d:.3e} > {tol:.3e}")
            worst = max(worst, d)
    return worst


def _corr_diff(got, want, want_cpu):
    """chunk_corr: slice origins and step0 exact (the chain's int rows
    depend on them) against the plain version on the CPU, which divides
    as the kernel does (on CUDA tensors torch divides by a Python scalar as
    a multiply by the float reciprocal); lag windows within 1e-4 of max|z|
    of the plain version on the card (the kernel's sums run in another
    order than cuBLAS').  Returns (max |diff|, max|z|)."""
    zr, zi, s_reg, step0 = (t.cpu() for t in got)
    wr, wi, ws, _ = (t.cpu() for t in want)
    _, _, s_cpu, step0_cpu = want_cpu
    if not (torch.equal(s_reg, ws) and torch.equal(s_reg, s_cpu)):
        raise AssertionError("chunk_corr slice origins differ")
    if not torch.equal(step0, step0_cpu):
        raise AssertionError("chunk_corr step0 differs from the CPU's")
    scale = float(max(wr.abs().max(), wi.abs().max()))
    d = float(max((zr - wr).abs().max(), (zi - wi).abs().max()))
    if not d <= 1e-4 * scale:
        raise AssertionError(f"chunk_corr |diff| {d:.3e} > 1e-4 x max|z| "
                             f"{scale:.3e}")
    return d, scale


def _time_cuda(fn, n):
    """Per-call time from CUDA events around n back-to-back calls."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _device_ms(fn, n):
    """Device time per call: the kernels' durations in a profiler trace of
    n calls, summed, over n.  Raises when the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    us = sum(e["dur"] for e in events if e.get("cat") == "kernel")
    if not us > 0:
        raise AssertionError("the profiler trace holds no kernel event")
    return us / n * 1e-3


def phase_kernels(dev, cc, tc):
    from gnss_sdr_1_tpu_torch.ops import track_capture as tcap

    # a real chunk taken mid-track: 0.25 s of tracking on the engine
    # benchmark's scenario, then the next chunk's inputs
    sats = _bench_sats(0.3)
    x = _gen(sats, 0.3, "kernel_chunk_0.3s_v1")
    eng = _engine(dev)
    spec, cspec = eng.chain_spec, eng.corr_spec
    assert (spec.E, spec.LW, spec.C, spec.K, cspec.NW) == (
        16, 68, 12, 3, 4136), (spec, cspec)
    st = _activate_all(eng, sats)
    xd = torch.as_tensor(x, device=dev)
    span = int(FS * 0.25)
    st, _ = eng.track_capture(xd[: span + eng.cfg.epoch_samples_max], st,
                              span)
    seg = eng._pad_for_chunks(xd[span:])
    fst, ist = eng._pack_rows(st, int(FS * 0.04))
    slot = st.prn_slot.to(torch.int32).contiguous()
    sec_rows = eng._sec[slot.long()].T.contiguous()
    rows = eng._rows

    # ---- chunk_corr: the mid-track chunk and random samples ----
    g = torch.Generator(device="cpu").manual_seed(7)
    noise = torch.randn((seg.shape[0], 2), generator=g) * 100.0
    seg_rand = torch.view_as_complex(noise).to(dev)
    corr_out, corr_err, corr_scale = {}, {}, {}
    for label, samples in (("random", seg_rand), ("track", seg)):
        before = cc.launches
        got = cc.chunk_corr(cspec, samples, rows, slot, fst, ist)
        torch.cuda.synchronize()
        if cc.launches != before + 1:
            raise AssertionError("chunk_corr wrapper did not launch")
        want = cc.chunk_corr_plain(cspec, samples, rows, slot, fst, ist)
        want_cpu = cc.chunk_corr_plain(
            cspec, *(t.cpu() for t in (samples, rows, slot, fst, ist)))
        corr_err[label], corr_scale[label] = _corr_diff(got, want, want_cpu)
        corr_out[label] = got
    wr, wi, _, _ = cc.windows_plain(cspec, seg, fst, ist)
    bank_t = cc.replica_bank(cspec, rows, slot)

    def corr_call():
        cc.chunk_corr_cuda(cspec, seg, rows, slot, fst, ist)

    def bmm_pair():
        torch.bmm(wr, bank_t)
        torch.bmm(wi, bank_t)

    corr_ms = _device_ms(corr_call, 200)
    corr_host = _time_cuda(corr_call, 500)
    corr_plain = _time_cuda(
        lambda: cc.chunk_corr_plain(cspec, seg, rows, slot, fst, ist), 20)
    bmm_ms = _device_ms(bmm_pair, 200)
    # least time: bytes (each channel's segment, its replica row, the state
    # rows read; the lag windows, slice origins and step0 written) against
    # operations (the lag products over this chunk's wiped samples)
    C, E, LW = cspec.C, cspec.E, cspec.LW
    n_wiped = int(((wr != 0) | (wi != 0)).sum())
    c_bytes = (C * cspec.seg_len * 8 + C * cspec.QW * 4
               + (fst.shape[0] + ist.shape[0]) * C * 4
               + (2 * C * E * LW + C * E + C) * 4)
    c_ops = 4 * LW * n_wiped + WIPE_OPS_PER_SAMPLE * n_wiped
    tb, to = c_bytes / PEAK_BYTES_S * 1e3, c_ops / PEAK_F32_S * 1e3
    corr_rep = {
        "err_random": corr_err["random"], "err_track": corr_err["track"],
        "scale_random": corr_scale["random"],
        "scale_track": corr_scale["track"],
        "max_abs_err": max(corr_err.values()), "ms": corr_ms,
        "ms_host": corr_host,
        "plain_ms": corr_plain, "library_ms": bmm_ms,
        "library": "torch.bmm pair on the plain path's wiped windows (the "
                   "product alone)",
        "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to
        else "operations", "bound_bytes": c_bytes, "bound_ops": c_ops,
        "wiped_samples": n_wiped, "NW": cspec.NW}

    # ---- track_chain: the correlator's mid-track output, random z ----
    zr_t, zi_t, s_reg, step0 = corr_out["track"]
    track_args = (zr_t, zi_t, s_reg, step0, sec_rows, fst, ist)
    zr = torch.randn(zr_t.shape, generator=g) * 100.0
    zi = torch.randn(zi_t.shape, generator=g) * 100.0
    rand_args = (zr.to(dev), zi.to(dev)) + track_args[2:]
    errs, rows_diff = {}, {}
    for label, args in (("random", rand_args), ("track", track_args)):
        before = tc.launches
        got = tc.chain(spec, *args)
        torch.cuda.synchronize()
        if tc.launches != before + 1:
            raise AssertionError("chain wrapper did not launch the kernel")
        want = tc.chain_plain(spec, *args)
        rows_diff[label] = []
        errs[label] = _chain_diff(tc, got, want, rows_diff[label])

    # ---- the capture entry: both kernels over several chunks in one call,
    #      against the plain chunk loop on the CPU ----
    cap_args = (seg, rows, slot, sec_rows, fst, ist)
    n_cap = CAPTURE_CHUNKS
    before = (cc.launches, tc.launches)
    got = tcap.track_capture(spec, cspec, n_cap, *cap_args)
    torch.cuda.synchronize()
    if (cc.launches, tc.launches) != (before[0] + n_cap, before[1] + n_cap):
        raise AssertionError("track_capture did not launch both kernels "
                             "for every chunk")
    want = tcap.track_capture_plain(spec, cspec, n_cap,
                                    *(t.cpu() for t in cap_args))
    errs["capture"] = _chain_diff(tc, got, want)
    n_valid_cap = int(want[0][:, tc.O_VALID].sum())
    if not n_valid_cap > 0:
        raise AssertionError("the capture check tracked no valid epoch")

    chain_ms = _device_ms(lambda: tc.chain_cuda(spec, *track_args), 200)
    chain_host = _time_cuda(lambda: tc.chain_cuda(spec, *track_args), 500)
    chain_plain = _time_cuda(lambda: tc.chain_plain(spec, *track_args), 5)

    # least time for the same work: bytes the function needs (the 2K lags
    # per plane each epoch reads, state and outputs once) vs operations
    K = spec.K
    sf, si = tc.n_frows(K), tc.N_IROWS
    n_bytes = 4 * (2 * 2 * K * E * C                 # lag reads, I and Q
                   + E * C + C + spec.sec_len * C     # s_reg, step0, sec
                   + 2 * (sf + si) * C                # state in and out
                   + E * (tc.N_OROWS + 2 + 2 * K) * C)  # per-epoch outputs
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = OPS_PER_EPOCH_CHANNEL * E * C / PEAK_F32_S * 1e3
    chain_rep = {
        "err_random": errs["random"], "err_track": errs["track"],
        "err_capture": errs["capture"], "capture_chunks": n_cap,
        "capture_valid_epochs": n_valid_cap,
        "max_abs_err": max(errs["random"], errs["track"]), "ms": chain_ms,
        "ms_host": chain_host,
        "plain_ms": chain_plain, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": n_bytes, "E": E, "LW": LW, "C": C, "K": K,
        "rows": rows_diff}
    return {"chunk_corr": corr_rep, "track_chain": chain_rep}


# ---------------------------------------------------------------------------
# phases 3 and 4: acquisition and the tracking engine (bench scenario)
# ---------------------------------------------------------------------------


def engine_capture():
    sats = _bench_sats(ENGINE_S)
    return sats, _gen(sats, ENGINE_S, f"engine_{ENGINE_S:g}s_v1")


def phase_acquisition(dev, sats, x):
    from gnss_sdr_1_tpu_torch.acquire import AcqConfig, PcpsAcquisition
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code

    prns = [s.prn for s in sats]
    cfg = AcqConfig(fs_hz=FS, samples_per_code=4092, samples_per_chip=4,
                    doppler_max_hz=5000.0, doppler_step_hz=250.0,
                    max_dwells=2, make_two_steps=False)
    codes = {p: gps_l1ca_code(p) for p in prns}
    acq = PcpsAcquisition(cfg, codes, fs_code_rate=(1.023e6, 1023),
                          device=dev)
    xs = x[: acq.cfg.fft_size * 2]
    res = acq.acquire(xs)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        acq.acquire(xs)
    wall = (time.perf_counter() - t0) / n
    ffts = len(prns) * acq.cfg.num_doppler_bins * 2 * 2
    # the card against the same acquisition on the CPU (ROADMAP.md's bar):
    # the same detections, the same Doppler bin, the delay within 1 sample,
    # the statistics to rtol 1e-4
    ref = PcpsAcquisition(cfg, codes, fs_code_rate=(1.023e6, 1023),
                          device="cpu").acquire(xs)
    if not np.array_equal(res.positive, ref.positive):
        raise AssertionError(f"acquisition detections differ from the CPU: "
                             f"{res.positive} vs {ref.positive}")
    if not np.array_equal(res.doppler_hz, ref.doppler_hz):
        raise AssertionError(f"acquisition Doppler bins differ from the "
                             f"CPU: {res.doppler_hz} vs {ref.doppler_hz}")
    dd_cpu = np.abs(res.delay_samples - ref.delay_samples)
    dd_cpu = np.minimum(dd_cpu, 4092 - dd_cpu)
    if not (dd_cpu <= 1.0).all():
        raise AssertionError(f"acquisition delays differ from the CPU by "
                             f"{dd_cpu}")
    rel = np.abs(res.test_stat - ref.test_stat) / np.abs(ref.test_stat)
    if not (rel <= 1e-4).all():
        raise AssertionError(f"acquisition statistics differ from the CPU "
                             f"by {rel}")
    # a detection at the truth: the code delay within 2 samples and the
    # Doppler within two 250 Hz bins (the 1 ms coherent window's main lobe
    # is +-1 kHz wide, so noise picks among neighbouring bins)
    found = []
    for k, s in enumerate(sats):
        true_delay = (s.delay_chips / 1.023e6 * FS) % 4092
        dd = abs(res.delay_samples[k] - true_delay)
        dd = min(dd, 4092 - dd)
        df = abs(res.doppler_hz[k] - s.doppler_hz)
        found.append({"prn": s.prn, "stat": float(res.test_stat[k]),
                      "stat_cpu": float(ref.test_stat[k]),
                      "doppler_err_hz": float(df), "delay_err": float(dd),
                      "hit": bool(res.positive[k] and df <= 500.0
                                  and dd <= 2.0)})
    det = sum(f["hit"] for f in found)
    if det < 10:
        raise AssertionError(f"acquisition found {det}/12 satellites: "
                             f"{found}")
    return {"detected": det, "ffts_per_s": ffts / wall,
            "ms_per_call": wall * 1e3, "fft_size": acq.cfg.fft_size,
            "cpu_max_delay_diff": float(dd_cpu.max()),
            "cpu_max_stat_rel": float(rel.max()), "per_prn": found}


def _count_chunks(eng):
    """Count the chunks the engine's capture calls run (ceil(n_epochs / E)
    per call), independently of the kernels' own launch counters."""
    counter = {"chunks": 0}
    run = eng._run_capture

    def counted(samples, state, limit, n_epochs):
        counter["chunks"] += -(-n_epochs // eng.chain_spec.E)
        return run(samples, state, limit, n_epochs)

    eng._run_capture = counted
    return counter


def _check_launches(cc, tc, chunks, what):
    if not chunks > 0:
        raise AssertionError(f"{what}: no chunk ran")
    for name, n in (("chunk_corr", cc.launches), ("track_chain",
                                                  tc.launches)):
        if n != chunks:
            raise AssertionError(f"{what}: {n} {name} launches for {chunks} "
                                 f"chunks")


def phase_engine(dev, cc, tc, sats, x):
    eng = _engine(dev)
    st = _activate_all(eng, sats)
    nmax = eng.cfg.epoch_samples_max
    xd = torch.as_tensor(x, device=dev)
    span = len(x) - nmax
    sym_off = np.full(12, 20, dtype=np.int32)
    # first-use warm-up (kernel load) on 0.1 s
    w = int(FS * 0.1)
    eng.track_capture_symbols(xd[: w + nmax], st, w, sym_off, 20)
    torch.cuda.synchronize()
    counter = _count_chunks(eng)
    cc.launches = tc.launches = 0
    t0 = time.perf_counter()
    st2, souts = eng.track_capture_symbols(xd, st, span, sym_off, 20)
    n_valid = int(souts.n_valid.sum())
    wall = time.perf_counter() - t0
    chunks = counter["chunks"]
    _check_launches(cc, tc, chunks, "engine")
    signal_s = span / FS
    expected = signal_s / 1e-3 * 12
    if not n_valid > 0.85 * expected:
        raise AssertionError(f"engine: {n_valid} valid epochs of "
                             f"{expected:.0f} expected")
    if not bool(st2.active.all()):
        raise AssertionError("engine: a channel lost lock")
    return {"rtf": signal_s / wall, "wall_s": wall, "signal_s": signal_s,
            "n_valid": n_valid, "expected": expected,
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches, "chunks": chunks}


# ---------------------------------------------------------------------------
# phase 5: the receiver end to end
# ---------------------------------------------------------------------------


def phase_e2e(dev, cc, tc):
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
    from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario

    dur = E2E_S
    prns = list(range(1, 13))
    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    scen = build_scenario(rx_ecef, prns, t0_tow=345601.25, duration_s=dur,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    t0 = time.perf_counter()
    x = _gen(scen.sats, dur, f"e2e_{FS:.0f}_{dur:.0f}_v1")
    gen_s = time.perf_counter() - t0
    rx = Receiver(ReceiverConfig(
        fs_hz=FS, signal_id="1C", n_channels=len(prns),
        prn_search=tuple(prns), reacq_interval_blocks=125,
        pvt_output_rate_ms=100), device=dev)
    rx.preload(x)
    counter = _count_chunks(rx.trk)
    cc.launches = tc.launches = 0
    t0 = time.perf_counter()
    sols = rx.process(x)
    wall = time.perf_counter() - t0
    _check_launches(cc, tc, counter["chunks"], "e2e")
    if len(sols) < MIN_FIXES:
        raise AssertionError(f"e2e: {len(sols)} fixes (< {MIN_FIXES})")
    e3d = np.linalg.norm(np.stack([s.rx_ecef_m for s in sols])
                         - scen.rx_ecef, axis=1)
    med = float(np.median(e3d))
    if not np.isfinite(e3d).all() or not med < 5.0:
        raise AssertionError(f"e2e: median 3D error {med:.2f} m")
    return {"rtf": dur / wall, "wall_s": wall, "fixes": len(sols),
            "median_3d_m": med, "max_3d_m": float(e3d.max()),
            "launches_chunk_corr": cc.launches,
            "launches_track_chain": tc.launches,
            "chunks": counter["chunks"], "gen_s": gen_s,
            "channels": list(rx.channel_prn)}


if __name__ == "__main__":
    main()
