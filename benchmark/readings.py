#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on this machine's GPU:
the program's numbers over many seeds and the control's over a few, in one
process (the kernels are built once).

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 2]

The control is the plain reference one precision below the
configuration's (TF32 lag products for the chunked correlator, bfloat16
for the gather walk), put in the program's place on the same segments.
Prints one JSON line a seed.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()

    import torch

    from gnssbench import harness

    if not torch.cuda.is_available():
        sys.stderr.write("readings: no CUDA device\n")
        return 2
    cell = harness.load_cell(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run(cell, s, args.seconds, False, "cuda", t0,
                        control=s in control)
        line = {"workload": cell.name, "seed": s, "correct": r["correct"],
                "segments": r["attempted"],
                "numbers": {**{k: v["value"] for k, v in r["checks"].items()},
                            **r["not_compared"]},
                "widest_gaps": r["widest_gaps"],
                "run_s": time.perf_counter() - t0}
        if "control_numbers" in r:
            line["control"] = r["control_numbers"]
            line["control_widest_gaps"] = r["control_widest_gaps"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
