"""A stream segment's front end: the raw items decoded, filtered by the
conf's frequency-translating FIR, decimated, rotated by the mixer's phase
and scaled.  The CUDA kernel's wrapper, its plain torch version, and the
wrapper that picks between them by the device of the segment.

GNU Radio's freq_xlating_fir_filter form of the batch Conditioner's
mix-then-filter (condition/filters.py): with w = -2 pi IF / fs,

    y[m] = scale * e^{j w D m} * sum_{k<T} g[k] x[H + m D - k],
    g[k] = h[k] e^{-j w k}

over a logical input of H history samples and the segment's samples; only
the kept outputs are computed.  A real input's taps multiply one plane, a
complex input's four products.  Every multiply and add rounds on its own
(the library is built with --fmad=false), the sums run k = 0 .. T-1 from
+0, the rotation is (re c - im s, re s + im c) and the scale multiplies
last, in the plain version as in the kernel (csrc/xlate_fir.cu).

The mixer's phase is exact at any absolute sample: output m's phase is
(phase0 + m F) mod 2^64 turns in units of 2^-64, phase0 = m0 F mod 2^64
for the segment's first output m0 (host integers, `fixed_phase`), so an
output reads the same phase whatever segment it falls in, and a stream
cut into segments gives the bits of one pass over it.  The top 32 bits, a
signed fraction of a half turn, give the cosine and sine in float64,
rounded to float32 once (the kernel's sincospi and numpy's cos(pi a) may
part in the last float32 bit now and then).

Signature of `xlate_fir` / `xlate_fir_plain` / `xlate_fir_cuda`:
    (hist (raw items of H samples, or None for zeros), seg (raw items),
     fmt ('nsr', 'ishort'/'cshort', 'ibyte'/'cbyte', 'gr_complex'),
     taps [T] complex64 (rotated), decim D, n_hist H, n_out, phase0,
     dphase (integers in [0, 2^64)), scale)
 -> [n_out] complex64 on the segment's device
"""

from __future__ import annotations

import ctypes
from fractions import Fraction

import numpy as np
import torch

# the raw formats the kernel decodes (csrc/xlate_fir.cu XF_*), and the
# item type each arrives in
FORMAT_CODES = {"nsr": 0, "ishort": 1, "cshort": 1, "ibyte": 2, "cbyte": 2,
                "gr_complex": 3}
ITEM_DTYPES = {0: torch.uint8, 1: torch.int16, 2: torch.int8,
               3: torch.complex64}
# source samples a raw item holds (nsr: four a byte) and items a sample
# takes (interleaved I/Q: two)
SAMPLES_PER_ITEM = {0: 4, 1: 1, 2: 1, 3: 1}
ITEMS_PER_SAMPLE = {0: 1, 1: 2, 2: 2, 3: 1}
MAX_TAPS = 1024
_TURN = 1 << 64

# kernel launches made by `xlate_fir_cuda` (never by xlate_fir_plain)
launches = 0


def format_code(fmt: str) -> int:
    if fmt not in FORMAT_CODES:
        raise ValueError(f"the stream front end decodes {sorted(FORMAT_CODES)}"
                         f", not {fmt!r}")
    return FORMAT_CODES[fmt]


def rotated_taps(taps, if_hz: float, fs_hz: float) -> np.ndarray:
    """g[k] = h[k] e^{j 2 pi IF k / fs} in float64, as complex64."""
    h = np.asarray(taps, np.float32).astype(np.float64)
    k = np.arange(h.size, dtype=np.float64)
    return (h * np.exp(2j * np.pi * if_hz * k / fs_hz)).astype(np.complex64)


def phase_step(if_hz: float, fs_hz: float, decim: int) -> int:
    """F: an output's mixer phase step -IF D / fs turns, modulo one turn,
    in units of 2^-64 turn (from the exact values of the float
    arguments)."""
    f = -Fraction(if_hz) * int(decim) / Fraction(fs_hz)
    return int(round((f - (f.numerator // f.denominator)) * _TURN)) % _TURN


def fixed_phase(m0: int, dphase: int) -> int:
    """The phase of absolute output m0, m0 F mod 2^64."""
    return (int(m0) * int(dphase)) % _TURN


def _decode(raw: torch.Tensor, code: int):
    """Raw items -> (re, im or None) float32 source samples."""
    if code == 0:
        b = raw.to(torch.int32)
        v = torch.stack([(b >> (2 * j)) & 3 for j in range(4)], dim=1)
        v = torch.where(v >= 2, v - 4, v).reshape(-1)
        return v.to(torch.float32), None
    if code == 3:
        iq = torch.view_as_real(raw.reshape(-1))
    else:
        iq = raw.reshape(-1, 2)
    iq = iq.to(torch.float32)
    return iq[:, 0], iq[:, 1]


def _rotation(n_out: int, phase0: int, dphase: int):
    """(cos, sin) of each output's mixer phase, float32 [n_out] numpy."""
    m = np.arange(n_out, dtype=np.uint64)
    with np.errstate(over="ignore"):
        ph = np.uint64(phase0) + m * np.uint64(dphase)
    half_turns = (ph >> np.uint64(32)).astype(np.uint32).view(np.int32)
    a = np.pi * (half_turns.astype(np.float64) * 2.0 ** -31)
    return np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)


def xlate_fir_plain(hist, seg, fmt: str, taps, decim: int, n_hist: int,
                    n_out: int, phase0: int, dphase: int,
                    scale: float) -> torch.Tensor:
    """The front end in plain torch ops where `seg` lies (a Python loop
    over the taps, each a strided view of the logical input)."""
    code = format_code(fmt)
    D, H = int(decim), int(n_hist)
    taps = torch.as_tensor(taps).to(seg.device, torch.complex64)
    T = taps.shape[0]
    re, im = _decode(seg, code)
    n_in = (n_out - 1) * D + H + 1
    if H:
        if hist is None:
            hr = torch.zeros(H, dtype=torch.float32, device=seg.device)
            hi = None if im is None else hr
        else:
            hr, hi = _decode(hist, code)
        re = torch.cat([hr, re])
        im = None if im is None else torch.cat([hi, im])
    if re.shape[0] < n_in:
        pad = torch.zeros(n_in - re.shape[0], dtype=torch.float32,
                          device=seg.device)
        re = torch.cat([re, pad])
        im = None if im is None else torch.cat([im, pad])
    gr, gi = taps.real.contiguous(), taps.imag.contiguous()
    ar = torch.zeros(n_out, dtype=torch.float32, device=seg.device)
    ai = torch.zeros_like(ar)
    for k in range(T):
        sl = slice(H - k, H - k + (n_out - 1) * D + 1, D)
        xr = re[sl]
        if im is None:
            ar = ar + gr[k] * xr
            ai = ai + gi[k] * xr
        else:
            xi = im[sl]
            ar = ar + (gr[k] * xr - gi[k] * xi)
            ai = ai + (gr[k] * xi + gi[k] * xr)
    c, s = (torch.from_numpy(v).to(seg.device)
            for v in _rotation(n_out, phase0, dphase))
    sc = torch.tensor(np.float32(scale), device=seg.device)
    return torch.complex((ar * c - ai * s) * sc, (ar * s + ai * c) * sc)


class XlateParams(ctypes.Structure):
    """Mirror of `XlateParams` in csrc/xlate_fir.cu (its static_assert
    states the size)."""

    _fields_ = [("n_out", ctypes.c_longlong), ("n_seg", ctypes.c_longlong),
                ("phase0", ctypes.c_ulonglong),
                ("dphase", ctypes.c_ulonglong),
                ("fmt", ctypes.c_int), ("D", ctypes.c_int),
                ("T", ctypes.c_int), ("H", ctypes.c_int),
                ("scale", ctypes.c_float), ("pad", ctypes.c_int)]


def _check_raw(t, name, code, dev):
    if t.device != dev:
        raise ValueError(f"{name} must lie on the segment's card")
    if t.dtype != ITEM_DTYPES[code]:
        raise ValueError(f"{name} has dtype {t.dtype}, expected "
                         f"{ITEM_DTYPES[code]}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def n_samples(raw: torch.Tensor, code: int) -> int:
    """Source samples a tensor of raw items holds."""
    return raw.numel() * SAMPLES_PER_ITEM[code] // ITEMS_PER_SAMPLE[code]


def xlate_fir_cuda(hist, seg, fmt: str, taps, decim: int, n_hist: int,
                   n_out: int, phase0: int, dphase: int,
                   scale: float) -> torch.Tensor:
    """One kernel launch on the current stream; never synchronises."""
    global launches
    from . import _build

    code = format_code(fmt)
    dev = seg.device
    _check_raw(seg, "seg", code, dev)
    if hist is not None:
        _check_raw(hist, "hist", code, dev)
        if n_samples(hist, code) != n_hist:
            raise ValueError(f"hist holds {n_samples(hist, code)} samples, "
                             f"expected {n_hist}")
    if not (taps.device == dev and taps.dtype == torch.complex64
            and taps.dim() == 1 and taps.is_contiguous()):
        raise ValueError("taps must be a contiguous complex64 vector on the "
                         "segment's card")
    T = taps.shape[0]
    if not 1 <= T <= MAX_TAPS or decim < 1 or n_hist < T - 1 or n_out < 1:
        raise ValueError(f"front end geometry: {T} taps (1 to {MAX_TAPS}), "
                         f"decimation {decim}, history {n_hist} (>= taps - "
                         f"1), {n_out} outputs (>= 1)")
    p = XlateParams(n_out=n_out, n_seg=n_samples(seg, code),
                    phase0=phase0, dphase=dphase, fmt=code, D=decim, T=T,
                    H=n_hist, scale=float(np.float32(scale)), pad=0)
    out = torch.empty(n_out, dtype=torch.complex64, device=dev)
    err = _build.xlate_library().xlate_fir_launch(
        None if hist is None else hist.data_ptr(), seg.data_ptr(),
        taps.data_ptr(), out.data_ptr(), ctypes.addressof(p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"xlate_fir kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def xlate_fir(hist, seg, fmt: str, taps, decim: int, n_hist: int,
              n_out: int, phase0: int, dphase: int,
              scale: float) -> torch.Tensor:
    """The kernel for a segment on the card, the plain version for one on
    the CPU."""
    fn = xlate_fir_cuda if seg.device.type == "cuda" else xlate_fir_plain
    return fn(hist, seg, fmt, taps, decim, n_hist, n_out, phase0, dphase,
              scale)
