#!/usr/bin/env python3
"""Run one cell of the benchmark of `gnss_sdr_1_tpu_torch` on this
machine's NVIDIA GPU and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a run with the profiler on over the window's first
segments.  Every run checks the timed path's outputs against the plain
reference and prints each number compared beside its limit, last on
standard error and under "checks" in the result line.  Exits 2 without a
result where no GPU (or fewer than the cell needs) is visible, and 1 where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]
# kernel caches of any library the port loads stay inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from gnssbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"benchmark: {cell.name} needs {cell.chips} CUDA "
                         f"device(s); none or too few are visible\n")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        sys.stderr.write(f"benchmark: forbidden modules loaded: {bad}\n")
        return 1
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name} {c['value']!r} limit "
                         f"{c['limit']!r}\n")
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
