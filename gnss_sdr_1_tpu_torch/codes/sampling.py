"""Code resampling to a sampling rate (host-side, NumPy).

Reference parity: gnss_signal_processing.cc `resampler` (:68-75) and the
per-signal `*_code_gen_complex_sampled` functions: nearest-previous-sample
(floor) resampling with no interpolation — the numerical contract in
SURVEY.md A.2 that the tracking code resampler must also honour.
"""

from __future__ import annotations

import numpy as np


def resample_code(
    chips: np.ndarray,
    fs_hz: float,
    code_rate_chips_s: float,
    n_samples: int | None = None,
    chip_shift: float = 0.0,
) -> np.ndarray:
    """Resample ±1 chips to `fs_hz`.

    out[n] = chips[floor((n * code_rate / fs) + chip_shift) mod L].
    If `n_samples` is None, one full code period is produced
    (round(fs * L / code_rate) samples).
    """
    length = len(chips)
    if n_samples is None:
        n_samples = int(round(fs_hz * length / code_rate_chips_s))
    n = np.arange(n_samples)
    idx = np.floor(n * (code_rate_chips_s / fs_hz) + chip_shift).astype(np.int64)
    return chips[np.mod(idx, length)]


def code_to_baseband(
    chips: np.ndarray,
    fs_hz: float,
    code_rate_chips_s: float,
    n_samples: int | None = None,
) -> np.ndarray:
    """Resampled code as complex64 baseband replica (imag = 0)."""
    return resample_code(chips, fs_hz, code_rate_chips_s, n_samples).astype(
        np.complex64
    )
