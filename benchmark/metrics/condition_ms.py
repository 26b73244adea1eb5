"""condition_ms: median host wall of a stream segment's front end, the
program's `stream.condition` span (the decode, filter, decimation,
rotation and scale enqueued as one launch), over the spans the program
recorded inside the measured window (the profiled warm-up before it is
left out)."""

import numpy as np


def _spans(run):
    """The program's spans inside the window; None where the program has
    no span module or the run no window."""
    t0 = getattr(run, "t0", None)
    try:
        from gnss_sdr_1_tpu_torch.utils import spans
    except ImportError:
        return None
    if t0 is None:
        return None
    a, b = int(t0 * 1e9), int((t0 + run.wall_s) * 1e9)
    return [s for s in spans.records() if a <= s.start_ns and s.end_ns <= b]


def read(run):
    v = [s.dur_ns for s in _spans(run) or ()
         if s.name == "stream.condition"]
    return float(np.median(v)) * 1e-6 if v else None
