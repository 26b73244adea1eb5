"""device_wait_ms: median, over the window's segments, of the host's time
blocked on the card in the engine: the program's `engine.*` wait spans
(the symbol grid's offsets upload and reads, a harvest's event wait)
summed over each segment that has engine spans and was opened inside the
window, from the spans the program recorded inside the measured
window."""

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
    rec = _spans(run) or ()
    # a segment counts where the span that opened it lies in the window
    opened = {s.id for s in rec if s.id == s.segment}
    per_seg = {s.segment: 0 for s in rec
               if s.name.startswith("engine.") and s.segment in opened}
    for s in rec:
        if s.wait and s.name.startswith("engine.") and s.segment in per_seg:
            per_seg[s.segment] += s.dur_ns
    v = list(per_seg.values())
    return float(np.median(v)) * 1e-6 if v else None
