#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's time goes, on one NVIDIA GPU.

    python3 tools/profile_torch_port.py [--engine-s 3] [--e2e-s 30]

1. Engine: the bench scenario (12 channels, 4.092 Msps, seed 42) tracked
   with `track_capture_symbols` under torch.profiler: the device busy
   share (union of the trace's kernel intervals / profiled wall), the top
   kernels by device time, the top host operators, and the wall per
   16-epoch chunk.  The Chrome trace goes to
   <out>/profile_engine_trace.json.
2. Receiver: the 12-satellite e2e scenario (bench.py:_bench_e2e) with wall
   timers around acquisition, tracking, the two harvests, observables+PVT
   and the rest of the host loop.
Prints one summary line per part and writes <out>/profile_port.json
(`--out`, default chip_smoke_cache/).
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _kernel_summary(trace_path: pathlib.Path, n_chunks: int) -> dict:
    """Device time from the exported Chrome trace: the union of the kernel
    intervals (the device's busy time) and the top kernels by name."""
    data = json.loads(trace_path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    kern = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "kernel")
    busy, cur_s, cur_e = 0.0, kern[0][0], kern[0][1]
    for s, e, _ in kern[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict[str, float] = {}
    for s, e, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"kernel_launches": len(kern), "busy_us": busy,
            "top_kernels_us_per_chunk": [(n, t / n_chunks) for n, t in top]}


def profile_engine(cs, tc, seconds: float, out: pathlib.Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    sats = cs._bench_sats(seconds)
    x = cs._gen(sats, seconds, f"engine_{seconds:g}s_v1")
    eng = cs._engine(dev)
    st = cs._activate_all(eng, sats)
    nmax = eng.cfg.epoch_samples_max
    xd = torch.as_tensor(x, device=dev)
    span = len(x) - nmax
    sym_off = np.full(12, 20, dtype=np.int32)
    w = int(cs.FS * 0.1)
    eng.track_capture_symbols(xd[: w + nmax], st, w, sym_off, 20)
    torch.cuda.synchronize()
    tc.launches = 0
    t0 = time.perf_counter()
    eng.track_capture_symbols(xd, st, span, sym_off, 20)
    plain_wall = time.perf_counter() - t0
    chunks = tc.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.track_capture_symbols(xd, st, span, sym_off, 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = out / "profile_engine_trace.json"
    prof.export_chrome_trace(str(trace))
    k = _kernel_summary(trace, chunks)
    top_cpu = sorted(
        ({"name": evt.key, "count": int(evt.count),
          "cpu_us": float(evt.self_cpu_time_total)}
         for evt in prof.key_averages()), key=lambda r: -r["cpu_us"])[:10]
    signal_s = span / cs.FS
    return {"signal_s": signal_s, "wall_s": plain_wall,
            "rtf": signal_s / plain_wall, "profiled_wall_s": wall,
            "chunks": chunks, "ms_per_chunk": plain_wall / chunks * 1e3,
            "kernels_per_chunk": k["kernel_launches"] / chunks,
            "device_busy_us_per_chunk": k["busy_us"] / chunks,
            "device_busy_share": k["busy_us"] * 1e-6 / wall,
            "top_kernels_us_per_chunk": k["top_kernels_us_per_chunk"],
            "top_cpu": top_cpu}


def profile_e2e(cs, seconds: float) -> dict:
    from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
    from gnss_sdr_1_tpu_torch.siggen.scenario import build_scenario

    dev = torch.device("cuda")
    prns = list(range(1, 13))
    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    scen = build_scenario(rx_ecef, prns, t0_tow=345601.25,
                          duration_s=seconds, cn0_dbhz=47.0,
                          subframe_cycle=(1, 2, 3))
    x = cs._gen(scen.sats, seconds, f"e2e_{cs.FS:.0f}_{seconds:.0f}_v1")
    rx = Receiver(ReceiverConfig(
        fs_hz=cs.FS, signal_id="1C", n_channels=len(prns),
        prn_search=tuple(prns), reacq_interval_blocks=125,
        pvt_output_rate_ms=100), device=dev)
    rx.preload(x)
    spent: dict[str, float] = {}
    calls: dict[str, int] = {}

    def timed(fn, key):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
                calls[key] = calls.get(key, 0) + 1
        return wrapper

    rx.acq.acquire = timed(rx.acq.acquire, "acquisition")
    rx.trk.track_capture = timed(rx.trk.track_capture, "track_capture")
    rx.trk.track_capture_symbols = timed(rx.trk.track_capture_symbols,
                                         "track_capture_symbols")
    rx._harvest = timed(rx._harvest, "harvest")
    rx._harvest_symbols = timed(rx._harvest_symbols, "harvest_symbols")
    rx._observables_and_pvt = timed(rx._observables_and_pvt,
                                    "observables_pvt")
    t0 = time.perf_counter()
    sols = rx.process(x)
    wall = time.perf_counter() - t0
    spent["rest_of_loop"] = wall - sum(spent.values())
    return {"signal_s": seconds, "wall_s": wall, "rtf": seconds / wall,
            "fixes": len(sols), "spent_s": spent, "calls": calls}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine-s", type=float, default=3.0)
    ap.add_argument("--e2e-s", type=float, default=30.0)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chip_smoke_cache")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("profile_torch_port: no CUDA device\n")
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gnss_sdr_1_tpu_torch.ops import track_chain as tc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    report = {"card": smi}
    if args.engine_s > 0:
        args.out.mkdir(parents=True, exist_ok=True)
        e = profile_engine(cs, tc, args.engine_s, args.out)
        report["engine"] = e
        print(f"engine: {e['signal_s']:.2f} s signal, RTF {e['rtf']:.2f}, "
              f"{e['ms_per_chunk']:.3f} ms/chunk over {e['chunks']} chunks, "
              f"{e['kernels_per_chunk']:.1f} kernels/chunk, device busy "
              f"{e['device_busy_us_per_chunk']:.1f} us/chunk = "
              f"{e['device_busy_share']:.3f} of the profiled wall "
              f"{e['profiled_wall_s']:.3f} s", flush=True)
        for name, us in e["top_kernels_us_per_chunk"]:
            print(f"  device {us:9.2f} us/chunk  {name[:70]}")
        for r in e["top_cpu"]:
            print(f"  host   {r['cpu_us'] / e['chunks']:9.2f} us/chunk  "
                  f"x{r['count']:<6d} {r['name'][:60]}")
    if args.e2e_s > 0:
        r = profile_e2e(cs, args.e2e_s)
        report["e2e"] = r
        parts = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
            r["spent_s"].items(), key=lambda kv: -kv[1]))
        print(f"e2e: {r['signal_s']:g} s signal, wall {r['wall_s']:.3f} s, "
              f"RTF {r['rtf']:.2f}, fixes {r['fixes']}: {parts}",
              flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "profile_port.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
