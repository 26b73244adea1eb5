"""launch_ms: median host wall of the call that enqueues a segment's
kernels (`launch_capture` on the stream path; the capture entry inside
`track_capture_symbols` on the symbol path), from the harness's spans."""

import numpy as np


def read(run):
    v = [s["launch_s"] for s in run.segments if "launch_s" in s]
    return float(np.median(v)) * 1e3 if v else None
