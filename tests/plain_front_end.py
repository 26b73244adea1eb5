"""A plain reference of a stream's front end for the tests, independent of
the port (it imports nothing of it, no kernel): the raw items decoded,
each source sample mixed down from the IF with its phase reduced modulo
one turn in float64, a direct-form FIR of the mixed samples with every
D-th output kept (a strided conv1d over the I and Q planes), the ingest
scale; plain torch in float32, TF32 off.  The twin of the benchmark's
reference, benchmark/gnssbench/reference/front_end.py.

    y[m] = scale * sum_{k<T} h[k] x[m D - k] e^{-j 2 pi IF (m D - k) / fs}

over the whole stream from source sample 0 (samples before it are
zeros).  The taps are the conf's input filter as the deployment's
`assumed` states it: a Hamming-windowed sinc of `n_taps` at 0.45 of the
internal rate, unit gain at DC, or the one tap 1.0 of a Direct_Resampler with a
whole-number ratio (its nearest previous sample is sample m D).

`lowp` (the check's control) rounds the FIR's operands, the mixed samples
and the taps, to a lower precision before the products.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# source samples a raw item holds, and items a sample takes
_SPI = {"nsr": 4, "ishort": 1, "ibyte": 1}
_IPS = {"nsr": 1, "ishort": 2, "ibyte": 2}


def lowpass_taps(n_taps: int, cutoff_hz: float, fs_hz: float) -> np.ndarray:
    """Hamming-windowed sinc low-pass, unit DC gain, float32."""
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    fc = cutoff_hz / fs_hz
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.hamming(n_taps)
    return (h / h.sum()).astype(np.float32)


@dataclass(frozen=True)
class Plan:
    """A deployment's front end: raw format, source rate, IF, decimation
    and taps."""

    fmt: str
    fs_hz: float
    if_hz: float
    decim: int
    taps: np.ndarray

    @property
    def n_taps(self) -> int:
        return len(self.taps)


def plan_of(config: dict) -> Plan:
    """The front end a configuration's `source_keys` set: an input filter
    (Freq_Xlating_Fir_Filter or Fir_Filter, or any IF) of `n_taps`
    (assumed 65) decimating by InputFilter.decimation_factor, else a
    Direct_Resampler's whole-number ratio with the one tap 1.0."""
    keys = config["source_keys"]
    fs = float(keys["SignalSource.sampling_frequency"])
    fs_int = float(keys["GNSS-SDR.internal_fs_sps"])
    if_hz = float(keys.get("InputFilter.IF", 0.0))
    decim = int(round(fs / fs_int))
    if abs(fs / fs_int - decim) > 1e-9:
        raise ValueError("the reference conditions whole-number ratios")
    filt = keys.get("InputFilter.implementation", "Pass_Through")
    if if_hz or filt in ("Fir_Filter", "Freq_Xlating_Fir_Filter"):
        d = int(keys.get("InputFilter.decimation_factor", decim))
        if d != decim:
            raise ValueError("the input filter decimates to the internal "
                             "rate in the deployments the benchmark runs")
        taps = lowpass_taps(int(config.get("n_taps", 65)), 0.45 * fs_int,
                            fs)
    else:
        taps = np.ones(1, np.float32)
    return Plan(config["item_type"], fs, if_hz, decim, taps)


def decode(raw: np.ndarray, fmt: str) -> torch.Tensor:
    """Raw items -> complex64 source samples: nsr four real two's
    complement 2-bit samples a byte, the least significant pair first;
    ishort / ibyte interleaved I/Q."""
    if fmt == "nsr":
        b = torch.from_numpy(np.asarray(raw, np.uint8)).to(torch.int32)
        v = torch.stack([(b >> (2 * j)) & 3 for j in range(4)], dim=1)
        v = torch.where(v >= 2, v - 4, v).reshape(-1).to(torch.float32)
        return torch.complex(v, torch.zeros_like(v))
    iq = torch.from_numpy(np.asarray(raw)).to(torch.float32).reshape(-1, 2)
    return torch.complex(iq[:, 0].contiguous(), iq[:, 1].contiguous())


def samples(items: np.ndarray, fmt: str, first: int, n: int) -> torch.Tensor:
    """Source samples first .. first + n - 1 of the stream whose raw items
    are `items` (zeros before sample 0 and past the end)."""
    spi, ips = _SPI[fmt], _IPS[fmt]
    a, b = max(first, 0), max(first + n, 0)
    ia, ib = a // spi * ips, -(-b // spi) * ips
    x = decode(items[ia:ib], fmt)[a - ia // ips * spi:][:b - a]
    pad_lo = torch.zeros(a - first, dtype=torch.complex64)
    pad_hi = torch.zeros(n - (a - first) - x.shape[0],
                         dtype=torch.complex64)
    return torch.cat([pad_lo, x, pad_hi])


def mix_down(x: torch.Tensor, first: int, if_hz: float,
             fs_hz: float) -> torch.Tensor:
    """x[n] e^{-j 2 pi IF n / fs} for n = first, first + 1, ..., the phase
    reduced modulo one turn in float64 (the first sample's from the exact
    values of the float arguments)."""
    if if_hz == 0.0:
        return x
    step = -if_hz / fs_hz
    base = float(-Fraction(if_hz) * first / Fraction(fs_hz) % 1)
    n = torch.arange(x.shape[0], dtype=torch.float64)
    ang = 2.0 * np.pi * torch.remainder(base + step * n, 1.0)
    rot = torch.complex(torch.cos(ang), torch.sin(ang)).to(torch.complex64)
    return x * rot


def front_end(items: np.ndarray, plan: Plan, first_out: int, n_out: int,
              scale: float = 1.0, lowp=None) -> torch.Tensor:
    """Outputs first_out .. first_out + n_out - 1 of the stream, complex64
    [n_out] on the host."""
    T, D = plan.n_taps, plan.decim
    first = first_out * D - (T - 1)
    n_in = (n_out - 1) * D + T
    xm = mix_down(samples(items, plan.fmt, first, n_in), first, plan.if_hz,
                  plan.fs_hz)
    planes = torch.stack([xm.real, xm.imag])[:, None, :]
    w = torch.flip(torch.from_numpy(plan.taps), [0])[None, None, :]
    if lowp is not None:
        planes, w = lowp(planes.contiguous()), lowp(w.contiguous())
    y = torch.nn.functional.conv1d(planes, w, stride=D)[:, 0, :n_out]
    s = np.float32(scale)
    return torch.complex(y[0] * s, y[1] * s)
