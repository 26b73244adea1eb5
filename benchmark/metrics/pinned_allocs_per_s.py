"""pinned_allocs_per_s: pinned host allocations per second of signal: the
program's `pinned_allocs` counts (`engine.read_back`'s readback tensors,
`stream.upload`'s staging buffers) a segment, as the median over the
window's segments of each kind (a segment's kind is the name of the span
that opened it), summed over the kinds and divided by a segment's seconds
of signal; from the spans the program recorded inside the measured
window."""

import collections

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
    rec = _spans(run)
    if not rec:
        return None
    # a segment counts where the span that opened it lies in the window
    kind = {s.id: s.name for s in rec if s.id == s.segment}
    n = collections.Counter()
    for s in rec:
        n[s.segment] += s.counts.get("pinned_allocs", 0)
    by_kind = collections.defaultdict(list)
    for seg, k in kind.items():
        by_kind[k].append(n[seg])
    per_seg = sum(float(np.median(v)) for v in by_kind.values())
    return per_seg / (run.span / run.fs)
