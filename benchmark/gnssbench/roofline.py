"""The least time of a segment's tracking work on an H100, whatever
kernels carry it.

The work is that of the whole walk, not of one kernel, so a later fusion
or split of kernels, or the chunked against the gather implementation,
reads the same work:

- operations: the correlated samples of the valid epochs times the
  per-sample operations of a K-tap correlation, and one loop closure per
  valid epoch;
- bytes: each input byte once, in the form the cell hands it to the
  program, the code rows, the loop state read and written, and the rows
  the cell reads back.

Each operation is priced at the fastest published H100 rate that can
carry it in float32: the K taps' accumulations at the TF32 tensor-core
rate (the lag products run as TF32 passes there), the rest at the float32
rate.  The least time is the larger of the operations' time and the
bytes' time.  The constants are copied from `chip_smoke.py`.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# outside the tensor cores, TF32 on the tensor cores (dense)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 495e12
# float32 operations per (epoch, channel) of the loop closure: tap reads
# ~45, rotation ~20, wipe/accumulate ~12, discriminators ~60, PLL ~15,
# DLL ~30, NCO ~15, CN0/lock ~25, ledger ~10, each transcendental ~8
OPS_PER_EPOCH_CHANNEL = 300
# float32 operations per correlated sample: the phase (2), its sine and
# cosine (~8 each), the wipe (6), K code indices (3 each) and K complex
# accumulations (2 each)
GATHER_OPS_PER_SAMPLE = {3: 39, 5: 49}


def least_time(work: dict) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes') for one segment's `work`."""
    K = work["taps"]
    n = work["samples"]
    acc = 2 * K * n
    rest = (GATHER_OPS_PER_SAMPLE[K] - 2 * K) * n \
        + OPS_PER_EPOCH_CHANNEL * work["valid_epochs"]
    t_ops = rest / PEAK_F32_S + acc / PEAK_TF32_S
    nbytes = (work["input_bytes"] + work["table_bytes"]
              + work["state_bytes"] + work["out_bytes"])
    t_bytes = nbytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
