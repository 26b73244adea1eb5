"""The least time of a segment's conditioning work on an H100, whatever
kernels carry it, and the device time of the kernels that did.

The work is that of the front end's function, counted from its shapes:

- operations: per kept output, n_taps multiply-adds of a complex tap
  into the sample (4 float32 operations for a real sample, 8 for a
  complex one), one rotation (6, and 16 for its sine and cosine) and the
  scale (2);
- bytes: the raw items in once, the complex64 output once, the taps.

Operations at the H100's float32 rate, bytes at its HBM3 rate
(`gnssbench.roofline`'s peaks); the least time is the larger of the two.
"""

from __future__ import annotations

from .roofline import PEAK_BYTES_S, PEAK_F32_S

# float32 operations per output besides the taps: the rotation (4
# multiplies, 2 adds), its sine and cosine (~8 each) and the scale
OPS_PER_OUTPUT = 6 + 16 + 2


def least_time(work: dict) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes') for one segment's `work`
    (entries/source_stream.py `_work`)."""
    per_tap = 8 if work["complex_input"] else 4
    ops = work["outputs"] * (work["taps"] * per_tap + OPS_PER_OUTPUT)
    t_ops = ops / PEAK_F32_S
    nbytes = work["input_bytes"] + work["out_bytes"] + work["tap_bytes"]
    t_bytes = nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_seconds(prof, name: str) -> float:
    """The summed device time of the kernels whose name holds `name` in a
    stopped torch.profiler profile."""
    total = 0
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()) and name in e.name():
            total += e.duration_ns()
    return total * 1e-9
