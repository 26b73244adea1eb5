"""ingest_ms: median host wall of a segment's upload and unpack
(`PinnedStaging.upload` + `unpack_raw`), from the harness's spans."""

import numpy as np


def read(run):
    v = [s["ingest_s"] for s in run.segments if "ingest_s" in s]
    return float(np.median(v)) * 1e3 if v else None
