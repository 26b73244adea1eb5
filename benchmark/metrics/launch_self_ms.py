"""launch_self_ms: median, over the window's segments, of the engine's
host time outside the capture entry and the readback waits: each
`engine.launch_capture` or `engine.track_capture_symbols` span less its
`engine.enqueue`, `engine.symbols.*` and `engine.harvest*` children, summed
over the segment (the packing of the state rows, the capture's padding,
the secondary-code row gather, the rebase, the readback's queueing), from
the spans the program recorded inside the measured window."""

import collections

import numpy as np

ENTRIES = ("engine.launch_capture", "engine.track_capture_symbols")


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


def _elsewhere(name: str) -> bool:
    return name == "engine.enqueue" or name.startswith(
        ("engine.symbols.", "engine.harvest"))


def read(run):
    rec = _spans(run) or ()
    inner = collections.Counter()
    for s in rec:
        if s.parent is not None and _elsewhere(s.name):
            inner[s.parent] += s.dur_ns
    per_seg = collections.Counter()
    for s in rec:
        if s.name in ENTRIES:
            per_seg[s.segment] += s.dur_ns - inner[s.id]
    v = list(per_seg.values())
    return float(np.median(v)) * 1e-6 if v else None
