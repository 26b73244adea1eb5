"""The benchmark harness: a cell of BENCHMARK.json from its files, the
program under test built from the configuration, the inputs made from the
seed, the measured window, the per-layer readers and the check.

Everything that belongs to one configuration, traffic mix, entry, limit
set or per-layer metric lives in a file of its own that is found by name:

    benchmark/configs/<config>.json   the deployment as it is run
    benchmark/mixes/<traffic>.json    the traffic: sizes, ranges, counts
    benchmark/entries/<entry>.py      the timed path the mix names
    benchmark/limits/<cell>.json      the limits of the cell's check
    benchmark/metrics/<metric>.py     one per-layer metric's reader

The program is `gnss_sdr_1_tpu_torch`; nothing here imports JAX or the JAX
package, and the reference (`gnssbench.reference`) imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import signal as sig

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gnss_sdr_1_tpu")


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (an entry or a reader)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"gnssbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str) -> Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix,
    limits and metrics."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `gnss_sdr_1_tpu_torch` is not `gnss_sdr_1_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Ctx:
    """What one run holds: the cell, the program's objects, the inputs,
    the segments' records and what the check keeps."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        cfg = cell.config
        self.signal = cfg["signal"]
        self.fs = float(cfg["track"]["fs_hz"])
        base = int(round(self.fs * cfg["block_ms"] * 1e-3))
        self.span = base * int(cfg["reacq_interval_blocks"])
        self.segments: list[dict] = []     # one record a segment
        self.kept: dict = {}               # (pass, segment) -> outputs
        self.traced: list[dict] = []       # work of the traced segments
        self.launches: dict = {}


# --------------------------------------------------------------- program


def build_program(ctx: Ctx) -> None:
    """The tracking engine the configuration runs, its codes and the
    activation state of every channel at the scenario's truth."""
    from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine

    cfg = ctx.cell.config
    code = sig.CODES[ctx.signal["code"]]
    ctx.codes = np.stack([code(p) for p in cfg["prns"]])
    ctx.engine = TrackingEngine(TrackConfig(**cfg["track"]), ctx.codes,
                                device=ctx.device)
    ctx.nmax = ctx.engine.cfg.epoch_samples_max


class Truth(NamedTuple):
    """One channel's activation at the scenario's truth."""

    ch: int             # channel, and the slot of its code row
    delay: float        # samples to the first code boundary
    doppler: float      # Hz
    start: int          # first epoch's start sample
    phase: float        # carrier phase at that sample, rad
    bit0: int           # epochs from the first epoch to a symbol boundary


def truth_activation(ctx: Ctx) -> list:
    """Every channel's Truth."""
    s = ctx.signal
    out = []
    for ch, sat in enumerate(ctx.sats):
        q, r = divmod(sat.delay_chips, s["code_chips"])
        delay = r / s["code_rate_chips_s"] * ctx.fs
        start = int(np.floor(delay))
        out.append(Truth(ch, delay, sat.doppler_hz, start,
                         sig.carrier_phase(sat, start, ctx.fs),
                         int(q) % s["symbol_epochs"]))
    return out


def program_state(ctx: Ctx):
    """The program's loop state at the start of every pass: each channel
    pulled in at its truth (the engine's activate_channel), its carrier
    phase at the truth, and in states 3/4 where the configuration's steady
    state is the coherent extension (enable_extended)."""
    eng = ctx.engine
    st = eng.init_state()
    phases = []
    for t in ctx.truth:
        st = eng.activate_channel(st, t.ch, t.ch, t.delay, t.doppler, 0, 0)
        if ctx.cell.config["extended"]:
            st = eng.enable_extended(st, t.ch, t.bit0)
        phases.append(t.phase)
    return st._replace(rem_carr_phase_rad=torch.as_tensor(
        np.asarray(phases, np.float32), device=ctx.device))


def make_inputs(ctx: Ctx) -> None:
    """Satellites from the seed and the capture on the card, scaled to
    unit RMS as the receiver's ingest scales it (complex64 on the device
    for an entry that tracks a preloaded capture; ishort items on the host
    for a streaming entry, with the scale the receiver takes from them)."""
    mix, cfg = ctx.cell.mix, ctx.cell.config
    n_seg = int(mix["capture_s"] * ctx.fs) // ctx.span
    n_samp = n_seg * ctx.span + ctx.nmax
    ctx.n_seg = n_seg
    ctx.sats = sig.draw_sats(ctx.signal, mix, cfg["prns"], ctx.seed,
                             n_samp / ctx.fs)
    codes = {p: c for p, c in zip(cfg["prns"], ctx.codes)}
    x = sig.generate_on_card(ctx.signal, ctx.sats, codes, ctx.fs,
                             n_samp / ctx.fs, ctx.device, ctx.seed)
    ctx.truth = truth_activation(ctx)
    head = 1 << 18
    if ctx.cell.mix["entry"] == "stream":
        ctx.items = sig.to_ishort(x, float(cfg["ishort_scale"]))
        iq = ctx.items[: 2 * head].astype(np.float32)
        rms = float(np.sqrt(np.mean(iq[0::2] ** 2 + iq[1::2] ** 2)))
        ctx.scale = float(np.float32(1.0 / rms))
        ctx.capture = None
    else:
        h = x[:head]
        rms = float(torch.sqrt(torch.mean(h.real.double() ** 2
                                          + h.imag.double() ** 2)))
        ctx.scale = float(np.float32(1.0 / rms))
        ctx.capture = x * np.float32(ctx.scale)
    del x


def launch_counts() -> dict:
    """The port's exact launch counters (chunk correlator, chain, gather
    walk)."""
    from gnss_sdr_1_tpu_torch.ops import chunk_corr, gather_block, track_chain

    return {"chunk_corr": chunk_corr.launches,
            "track_chain": track_chain.launches,
            "gather_block": gather_block.launches}


# --------------------------------------------------------------- the run


def keep_set(ctx: Ctx) -> set:
    """The (pass, segment) pairs whose outputs the check compares, drawn
    from the seed before the window: the first two segments of the first
    pass (the reference walks both from its own start) and others over
    the first passes."""
    mix = ctx.cell.mix
    rng = np.random.default_rng([ctx.seed, 7])
    keep = {(0, 0), (0, 1)}
    while len(keep) < int(mix["compare_segments"]):
        keep.add((int(rng.integers(0, mix["keep_passes"])),
                  int(rng.integers(1, ctx.n_seg))))
    return keep


def set_up(cell: Cell, seed: int, trace: bool, dev: torch.device,
           t_start: float, fault=None):
    """Everything before the window, timed in parts: the program's engine,
    the inputs from the seed, the activation state, the warm-up of the
    cell's own shapes (and of the profiler, in a traced run)."""
    from .trace import Tracer

    ctx = Ctx(cell, seed, dev)
    entry = load_module("entries", cell.mix["entry"])
    parts = {"imports": time.perf_counter() - t_start}
    build_program(ctx)
    parts["program"] = time.perf_counter() - t_start
    make_inputs(ctx)
    ctx.init_state = program_state(ctx)
    ctx.keep = keep_set(ctx)
    if fault is not None:
        fault(ctx)
    entry.prepare(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["inputs"] = time.perf_counter() - t_start
    entry.warm_up(ctx)
    tracer = Tracer(trace and dev.type == "cuda",
                    int(cell.mix["trace_segments"]))
    tracer.warm_up(lambda: entry.warm_up(ctx))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["warm_up"] = time.perf_counter() - t_start
    ctx.setup_parts = parts
    return ctx, entry, tracer


def measure(ctx: Ctx, entry, tracer, seconds: float) -> None:
    """The window: the entry's segments until `seconds` have passed, then
    its drain; the launch counters read around it."""
    before = launch_counts()
    t0 = time.perf_counter()
    entry.window(ctx, t0 + seconds, tracer)
    ctx.wall_s = time.perf_counter() - t0
    after = launch_counts()
    ctx.launches = {k: after[k] - before[k] for k in after}
    ctx.done = [s for s in ctx.segments if s.get("t_rows") is not None]
    ctx.signal_s = len(ctx.done) * ctx.span / ctx.fs
    ctx.profile = tracer.summary
    ctx.t0 = t0


def host_record(ctx: Ctx) -> dict:
    """How the host ran the window, beside the metrics (a one-card
    machine shares its host's cores): hand-off intervals and the rate in
    each second of the window; in a traced run the profiler's count of
    the tracking kernels against the launch counters'."""
    gaps = np.diff([s["t_hand"] for s in ctx.segments]) * 1e3
    ends = np.array([s["t_rows"] for s in ctx.done]) - ctx.t0
    per_s = np.bincount(ends.astype(np.int64)) * ctx.span / ctx.fs
    host = {"cpus": len(os.sched_getaffinity(0)),
            "handoff_ms_p10_p50_p90": [float(v) for v in np.percentile(
                gaps, [10, 50, 90])] if len(gaps) else None,
            "rtf_by_second": [float(v) for v in per_s]}
    if ctx.profile is not None:
        per_seg = sum(ctx.launches.values()) / max(1, len(ctx.done))
        host["trace_kernels_seen_launched"] = [
            ctx.profile["tracking_kernels"], round(per_seg * len(ctx.traced))]
    return host


def metrics_of(ctx: Ctx, trace: bool) -> dict:
    """The cell's end-to-end metrics (`trace` 0) or its per-layer ones,
    each from its reader (`trace` 1)."""
    cell, out = ctx.cell, {}
    if not trace:
        lat = np.array([s["t_rows"] - s["t_hand"] for s in ctx.done]) * 1e3
        vals = {"rtf": ctx.signal_s / ctx.wall_s,
                "segment_p95_ms": float(np.percentile(lat, 95)),
                "setup_s": ctx.setup_parts["warm_up"]}
        for m in cell.end_to_end:
            if m["name"] in vals:
                out[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = load_module("metrics", m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None, control: bool = False) -> dict:
    """One run of a cell: set-up, the window, the readers, the check.
    `fault` (tests only) breaks the timed path underneath; `control` adds
    the control's readings: the reference one precision below the
    configuration's, in the program's place (`control_numbers`)."""
    from . import check

    dev = torch.device(device)
    ctx, entry, tracer = set_up(cell, seed, trace, dev, t_start, fault)
    measure(ctx, entry, tracer, seconds)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": int(
                       torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)}
    result = {"attempted": len(ctx.segments),
              "failed": len(ctx.segments) - len(ctx.done),
              "metrics": metrics_of(ctx, trace), "device": device_info,
              "setup_parts_s": ctx.setup_parts, "host": host_record(ctx)}
    if trace and ctx.profile is not None:
        device_info["busy_s"] = ctx.profile["busy_s"]
        device_info["window_s"] = ctx.profile["window_s"]
        result["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                               "idle_gaps": ctx.profile["idle_gaps"]}
    # the check, once the window has closed and the peak is read: the
    # program's engine is dropped and the reference runs on the host
    ctx.engine = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.compare(ctx)
    checks, result["not_compared"] = check.judge(numbers.values(),
                                                 cell.limits)
    result["widest_gaps"] = numbers.widest()
    result["correct"] = bool(result["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    if control:
        low = check.CONTROL[check.reference_for(ctx).cfg.correlator]
        low_numbers = entry.compare(ctx, control=low)
        result["control_numbers"] = low_numbers.values()
        result["control_widest_gaps"] = low_numbers.widest()
    result["checks"] = checks
    return result


def result_line(result: dict) -> str:
    """The result's JSON line: `correct` first, the checks last."""
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "setup_parts_s", "host", "widest_gaps",
             "not_compared", "checks"]
    return json.dumps({k: result[k] for k in order if k in result})
