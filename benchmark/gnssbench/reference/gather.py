"""Frozen copy of the port's plain gather walk (`ops/gather_block.py`
`gather_block_plain` with `ops/multicorrelator.py` `multicorrelate`): every
epoch of every channel in order, the exact per-sample code resampler, then
the chain's loop closure.  `lowp` rounds the samples and the wiped
products (None for float32; the control passes bfloat16 rounding)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .chain import (F_CARR_OFF, F_DELTA, F_DOPPLER, F_REM_CARR, F_REM_CODE,
                    I_ACTIVE, I_CURLEN, I_START, N_OROWS, ChainSpec, _f32,
                    loop_close_plain, loop_consts_plain)

_F32 = torch.float32


def _as_f32(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32, device=dev)


def _code_indices(n, code_phase_step, shifts, rem_code_phase, code_len: int):
    """[..., K, N] int64 gather indices into the 1-sample/chip code table."""
    chips = torch.addcmul(shifts[:, None], code_phase_step[..., None, None],
                          n) - rem_code_phase[..., None, None]
    # an integer remainder by a positive divisor is the floor modulo
    idx = torch.floor(chips).to(torch.int64)
    return torch.remainder(idx, code_len)


def multicorrelate(
    samples,            # [..., N] complex64 input segment
    code,               # [..., L] float32 +-1 chips (1 sample/chip)
    shifts_chips,       # [K] float32 correlator tap offsets (e.g. -E, 0, +L)
    code_phase_step,    # [...] chips/sample (code_freq / fs)
    rem_code_phase,     # [...] chips into the code at sample 0
    carr_phase_rad,     # [...] carrier phase at sample 0
    carr_step_rad,      # [...] rad/sample (2*pi*(IF+doppler)/fs)
    carr_rate_rad=0.0,  # [...] rad/sample^2 (high-dynamics phase acceleration)
    n_valid=None,       # [...] samples actually integrated (<= N); None = all
    lowp=None,          # rounding of the samples and the wiped products
):
    """Returns complex64 [..., K] correlator outputs.  Leading axes (e.g.
    channels) batch every argument but `shifts_chips`."""
    dev = samples.device
    N = samples.shape[-1]
    n = torch.arange(N, dtype=_F32, device=dev)
    cp, cs, cr = (_as_f32(v, dev)[..., None] for v in
                  (carr_phase_rad, carr_step_rad, carr_rate_rad))
    phase = torch.addcmul(torch.addcmul(cp, cs, n), 0.5 * cr * n, n)
    # (re + j im) (cos - j sin) in real products: the CPU's complex multiply
    # rounds its vectorised body and its scalar tail differently, so a
    # sample's bits would depend on where the call's tail falls
    c, s = torch.cos(phase), torch.sin(phase)
    if lowp is not None:
        samples = torch.complex(lowp(samples.real), lowp(samples.imag))
        c, s = lowp(c), lowp(s)
    wr = samples.real * c + samples.imag * s
    wi = samples.imag * c - samples.real * s
    if lowp is not None:
        wr, wi = lowp(wr), lowp(wi)
    if n_valid is not None:
        keep = n < _as_f32(n_valid, dev)[..., None]
        zero = torch.zeros((), dtype=_F32, device=dev)
        wr, wi = torch.where(keep, wr, zero), torch.where(keep, wi, zero)
    shifts = _as_f32(shifts_chips, dev)
    idx = _code_indices(n, _as_f32(code_phase_step, dev), shifts,
                        _as_f32(rem_code_phase, dev), code.shape[-1])
    lead = idx.shape[:-2]
    codes = torch.gather(code.expand(lead + code.shape[-1:])[..., None, :]
                         .expand(idx.shape[:-1] + code.shape[-1:]), -1, idx)
    # each channel's taps summed on their own, so a channel's bits do not
    # depend on how many channels share the call (a batched matmul takes
    # another path for one channel than for several)
    re = (codes * wr[..., None, :]).sum(-1)
    im = (codes * wi[..., None, :]).sum(-1)
    return torch.complex(re, im)


_TWO_PI = float(2.0 * np.pi)

def _recip(v) -> float:
    """The float32 reciprocal of a float32 value, rounded once."""
    return float(np.float32(1.0) / np.float32(v))


@dataclasses.dataclass(frozen=True)
class GatherSpec:
    """Static configuration of one gather walk: the chain's loop constants
    (`loop`; its E, LW and lag geometry are not read) and the correlation's
    geometry."""

    loop: ChainSpec
    n_max: int              # epoch_samples_max: samples a window holds
    win: int                # the window the offsets are clipped into
    code_len: int           # columns of a code row (code_len x spc)
    shifts: tuple           # [K] tap offsets in code-row samples
    spc: float              # code-row samples per chip

    @property
    def C(self) -> int:
        return self.loop.C

    @property
    def K(self) -> int:
        return self.loop.K

    # the JAX package's compiled epoch step divides by fs as a multiply by
    # its float32 reciprocal (XLA's rewrite of a division by a constant):
    # so do both versions here, on every device
    @property
    def inv_fs(self) -> float:
        return _recip(self.loop.fs)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def epoch_params(spec: GatherSpec, f):
    """The multicorrelator's per-channel arguments from the state rows, as
    the JAX `_epoch_step` rounds them: (code step, rem code in chips,
    carrier phase, carrier step)."""
    code_freq = _f32(spec.loop.chip_rate) + f[F_DELTA]
    code_step = code_freq * spec.inv_fs * _f32(spec.spc)
    rem_chips = code_freq * f[F_REM_CODE] * spec.inv_fs * _f32(spec.spc)
    carr_step = _TWO_PI * (f[F_DOPPLER] + f[F_CARR_OFF]) * spec.inv_fs
    return code_step, rem_chips, f[F_REM_CARR], carr_step


def window_offsets(spec: GatherSpec, ist, n_samp: int):
    """(m, off): the window origin over the active channels, clipped to the
    capture, and each channel's offset from it (JAX engine.py:799-807)."""
    active = ist[I_ACTIVE] > 0
    start = ist[I_START]
    win = min(spec.win, n_samp)
    m = torch.min(torch.where(active, start, torch.full_like(start, 1 << 29)))
    m = torch.clamp(m, 0, n_samp - win)
    off = torch.clamp(start - m, 0, win - spec.n_max)
    return m, off


def gather_block_plain(spec: GatherSpec, samples, codes, sec_rows, fst, ist,
                       n_epochs: int, lowp=None):
    """The walk in plain torch ops (any device); same rows as the kernel."""
    dev = samples.device
    C, K = spec.C, spec.K
    f32 = torch.float32
    shifts = torch.tensor(spec.shifts, dtype=f32, device=dev)
    n_idx = torch.arange(spec.n_max, device=dev)
    n_samp = samples.shape[0]
    out_f = torch.empty((n_epochs, N_OROWS, C), dtype=f32, device=dev)
    out_i = torch.empty((n_epochs, 2, C), dtype=torch.int32, device=dev)
    out_corr = torch.empty((n_epochs, 2 * K, C), dtype=f32, device=dev)
    consts = loop_consts_plain(spec.loop, ist)
    f, i = fst, ist
    for e in range(n_epochs):
        m, off = window_offsets(spec, i, n_samp)
        segs = samples[(m + off).to(torch.int64)[:, None] + n_idx]
        code_step, rem_chips, cp, cs = epoch_params(spec, f)
        corr = multicorrelate(segs, codes, shifts, code_step, rem_chips, cp,
                              cs, 0.0, i[I_CURLEN].to(f32),
                              lowp=lowp)                       # [C, K]
        f, i, out_f[e], out_i[e], out_corr[e], _ = loop_close_plain(
            spec.loop, consts, f, i, [corr[:, k].real for k in range(K)],
            [corr[:, k].imag for k in range(K)], sec_rows)
    return out_f, out_i, out_corr, f, i
