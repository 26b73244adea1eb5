"""Interference mitigation: notch filtering and pulse blanking (torch).

Reference parity: Notch_Filter / Notch_Filter_Lite (notch adaptive IIR on
CW interference, src/algorithms/input_filter/adapters/notch_filter.cc) and
Pulse_Blanking_Filter (pulse_blanking_filter.cc — zeroes samples above a
noise-floor multiple).  Spectral excision per FFT block for CW and
amplitude blanking for pulses, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .filters import to_device


def _pulse_blank(x, n_sigma: float = 4.0):
    """Zero samples whose magnitude exceeds n_sigma * RMS (pulse blanking).
    Returns (cleaned, blanked fraction as a 0-d tensor)."""
    p = x.real ** 2 + x.imag ** 2
    rms2 = torch.mean(p)
    mask = p <= (n_sigma * n_sigma) * rms2
    return (torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device)),
            torch.mean((~mask).to(torch.float32)))


def pulse_blanking(x: np.ndarray, n_sigma: float = 4.0,
                   device=None) -> tuple[np.ndarray, float]:
    """Returns (cleaned complex64, blanked fraction).  `device`: None runs
    on the card (and raises without one); the CPU only when asked for."""
    y, frac = _pulse_blank(to_device(x, resolve_device(device)), n_sigma)
    return y.cpu().numpy(), float(frac)


def _median_midpoint(p):
    """Median as the midpoint of the two central order statistics for an
    even count (numpy's and jnp.median's convention; torch.median takes the
    lower one)."""
    s, _ = torch.sort(p)
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _notch_block(x, excise_bw_bins: int, pfa_factor: float):
    """Spectral excision: null FFT bins whose power exceeds pfa_factor x the
    median bin power (CW interference lines), +- excise_bw_bins around each."""
    X = torch.fft.fft(x)
    p = X.real ** 2 + X.imag ** 2
    hot = p > pfa_factor * _median_midpoint(p)
    # widen the excision around detected lines
    widen = hot
    for k in range(1, excise_bw_bins + 1):
        widen = widen | torch.roll(hot, k) | torch.roll(hot, -k)
    Xc = torch.where(widen, torch.zeros((), dtype=X.dtype, device=X.device),
                     X)
    return (torch.fft.ifft(Xc).to(torch.complex64),
            torch.mean(widen.to(torch.float32)))


def notch_filter(x: np.ndarray, excise_bw_bins: int = 2,
                 pfa_factor: float = 30.0,
                 block: int = 1 << 15,
                 device=None) -> tuple[np.ndarray, float]:
    """Blockwise spectral excision of CW lines.
    Returns (cleaned complex64, mean excised bin fraction).  `device`: None
    runs on the card (and raises without one); the CPU only when asked
    for."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.complex64)
    outs, fracs = [], []
    for pos in range(0, len(x) - block + 1, block):
        y, frac = _notch_block(to_device(x[pos : pos + block], dev),
                               excise_bw_bins, pfa_factor)
        outs.append(y.cpu().numpy())
        fracs.append(float(frac))
    tail = len(x) % block
    if tail:
        outs.append(x[len(x) - tail:])
    return (np.concatenate(outs) if outs else x,
            float(np.mean(fracs)) if fracs else 0.0)
