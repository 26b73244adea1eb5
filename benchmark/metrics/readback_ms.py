"""readback_ms: median host wall from a segment's harvest call to its
rows on the host (`harvest_capture`; on the symbol path the rest of
`track_capture_symbols` after its capture entry: the symbol-grid
reduction and its read), from the harness's spans."""

import numpy as np


def read(run):
    v = [s["readback_s"] for s in run.segments if "readback_s" in s]
    return float(np.median(v)) * 1e3 if v else None
