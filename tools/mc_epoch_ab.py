#!/usr/bin/env python3
"""The one-epoch multicorrelator and the TCP connector's epoch in one or
more trees of this repository, on one NVIDIA GPU, each tree in a process of
its own, in the order given (name a tree twice to interleave two trees):

    python3 tools/mc_epoch_ab.py PARENT_TREE . . PARENT_TREE

For each tree: the gather library built from the tree's sources;
`multicorrelate_cuda` as the TCP connector calls it (C = 1, K = 3, Python
numbers, a tuple of tap offsets) at 4,094 and 2,046 samples: the kernel's
device time by its name, every other kernel and copy a call
(torch.profiler), the host time a call in a tight loop (before any
profiling); then chip_smoke.py phase 27's tracker and controller (PRN 3,
1.2 s at 2.046 Msps, the controller a thread) over 1000 epochs, three
times: the wall an epoch and its split from the tracker's stamps
(track/tcp_connector.py `track(..., stamps)`; for a tree without them this
tree's tcp_connector.py is loaded over the tree's package in its place,
and nothing is written to the tree).  One JSON line a measurement, then
the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

FS = 2.046e6
EPOCHS = 1000
RUNS = 3
HERE = pathlib.Path(__file__).resolve().parent.parent
TRACKER = "gnss_sdr_1_tpu_torch.track.tcp_connector"


def _tracker_module(tree: pathlib.Path):
    """The tree's tcp_connector module, or this tree's file over the
    tree's package where the tree's tracker takes no stamps."""
    import importlib
    import importlib.util

    path = tree / "gnss_sdr_1_tpu_torch" / "track" / "tcp_connector.py"
    if "stamps" in path.read_text():
        return importlib.import_module(TRACKER)
    importlib.import_module("gnss_sdr_1_tpu_torch.track")
    spec = importlib.util.spec_from_file_location(
        TRACKER, HERE / "gnss_sdr_1_tpu_torch" / "track" / "tcp_connector.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[TRACKER] = mod
    spec.loader.exec_module(mod)
    return mod


def _profile(fn, n):
    """{kernel or copy name: (device ms per call, events per call)} over n
    calls of fn (one call outside the trace first)."""
    import torch
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
    out = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy"):
            ms, k = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (ms + e["dur"] / n * 1e-3, k + 1)
    return {k: (ms, cnt / n) for k, (ms, cnt) in out.items()}


def _host_us(fn, n=2000):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def measure(tree: pathlib.Path) -> None:
    """Every measurement of one tree, in this process."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import gnss_sdr_1_tpu_torch
    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
    from gnss_sdr_1_tpu_torch.ops import _build
    from gnss_sdr_1_tpu_torch.ops import multicorrelator as mc
    from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband

    tcp = _tracker_module(tree)
    if not gnss_sdr_1_tpu_torch.__file__.startswith(str(tree)):
        raise RuntimeError(f"imported {gnss_sdr_1_tpu_torch.__file__}, not "
                           f"the tree {tree}")
    _build.gather_library()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    x = torch.complex(torch.randn(4096, generator=g),
                      torch.randn(4096, generator=g)).to(dev) * 30.0
    code = torch.as_tensor(gps_l1ca_code(3).astype(np.float32), device=dev)
    taps = (-0.5, 0.0, 0.5)
    for n in (4094, 2046):
        def call():
            mc.multicorrelate_cuda(x[1:1 + n], code, taps, 0.5000004, -0.31,
                                   1.7, 0.0025)

        host = _host_us(call)
        prof = _profile(call, 200)
        print(json.dumps({
            "tree": str(tree), "samples": n, "host_us": host,
            "kernel_ms": sum(v[0] for k, v in prof.items()
                             if "multicorrelate_kernel" in k),
            "others": {k: v for k, v in prof.items()
                       if "multicorrelate_kernel" not in k}}), flush=True)
    capture = generate_baseband(
        GPS_L1_CA, [SatParams(prn=3, doppler_hz=820.0, delay_chips=257.3,
                              cn0_dbhz=50.0)],
        {3: gps_l1ca_code(3)}, FS, 1.2, noise=True, seed=2)
    for run in range(RUNS):
        srv = tcp.LoopClosureServer(pll_bw_hz=20.0, dll_bw_hz=2.0,
                                    seed_doppler_hz=800.0)
        trk = tcp.TcpConnectorTracking(
            tcp.TcpTrackConfig(FS, 1023, 1.023e6, 1575.42e6),
            gps_l1ca_code(3), "127.0.0.1", srv.port)
        trk.seed(257.3 / 1.023e6 * FS, 800.0)
        stamps = []
        try:
            t0 = time.perf_counter()
            rows = trk.track(capture, EPOCHS, stamps)
            wall = time.perf_counter() - t0
        finally:
            trk.close()
            srv.close()
        t = np.asarray(stamps) * 1e3
        parts = {"correlate": t[:, 2] - t[:, 1],
                 "readback": t[:, 3] - t[:, 2],
                 "json_write": t[:, 4] - t[:, 3],
                 "reply": t[:, 5] - t[:, 4],
                 "nco": (t[:, 1] - t[:, 0]) + (t[:, 6] - t[:, 5])}
        print(json.dumps({
            "tree": str(tree), "run": run, "epochs": len(rows),
            "ms_per_epoch": wall / len(rows) * 1e3,
            **{k: [float(v.mean()), float(np.percentile(v, 90))]
               for k, v in parts.items()},
            "last_doppler_hz": rows[-1]["doppler_hz"]}), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        measure(pathlib.Path(sys.argv[2]).resolve())
        return
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        sys.exit(__doc__ if len(sys.argv) < 2 else "no CUDA device")
    for arg in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one",
                        str(pathlib.Path(arg).resolve())], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
