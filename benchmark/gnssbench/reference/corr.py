"""Frozen copy of the port's plain chunk correlator (window, frozen-NCO
carrier wipe-off and lag correlation of one chunk, `ops/chunk_corr.py`),
plus a `lowp` hook: a rounding applied to the wiped windows before the
lag products (None for float32; the control passes TF32 rounding)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import chain as tc

_TWO_PI = float(2.0 * np.pi)

def _f32(v) -> float:
    """Round a Python float to the nearest float32 value."""
    return float(np.float32(v))


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def row_width(LW: int, NW: int) -> int:
    """Floats per Toeplitz replica row: the LW - 1 + NW values of n - l,
    padded to a multiple of 4 (16-byte rows for the asynchronous copy)."""
    return _round4(LW - 1 + NW)


@dataclasses.dataclass(frozen=True)
class CorrSpec:
    """Static configuration of one chunk correlator."""

    E: int                  # epochs per chunk
    LW: int                 # lag-window length
    NW: int                 # samples per epoch window
    C: int                  # channels
    t0_int: int             # integer samples per code period
    t0_frac: float          # fractional samples per code period
    grid_pad: int           # regular grid starts this far before `start`
    chip_rate: float
    fs: float
    # TF32 passes of the kernel's product: 2 where every replica value is
    # exact in TF32 (the engine's code tables: +-1 and 0), 3 otherwise
    # (table_passes, when the engine builds the table)
    passes: int

    @property
    def QW(self) -> int:
        return row_width(self.LW, self.NW)

    @property
    def seg_len(self) -> int:
        return (self.E - 1) * self.t0_int + self.NW


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def replica_bank(spec: CorrSpec, rows, slot):
    """The per-channel replica bank as the batched matmul takes it:
    [C, NW, LW] (a transposed view of [C, LW, NW]),
    bank[c, n, l] = rows[slot[c], n - l + LW - 1]."""
    dev = rows.device
    idx = (torch.arange(spec.NW, device=dev)[None, :]
           - torch.arange(spec.LW, device=dev)[:, None] + spec.LW - 1)
    return rows[slot.long()][:, idx].transpose(1, 2)


def windows_plain(spec: CorrSpec, samples, fst, ist):
    """Window + wipe-off on the regular grid: (wr, wi [C, E, NW] f32, zero
    outside each epoch's true content; s_reg [C, E] i32; step0 [C] f32)."""
    E, NW, t0i = spec.E, spec.NW, spec.t0_int
    f32, i32 = torch.float32, torch.int32
    dev = samples.device
    n_samp = samples.shape[0]
    start, cur_len = ist[tc.I_START], ist[tc.I_CURLEN]
    rem_code, delta0 = fst[tc.F_REM_CODE], fst[tc.F_DELTA]

    # --- predict epoch starts/lengths under the frozen code frequency ---
    codef0 = _f32(spec.chip_rate) + delta0
    d_t0 = _f32(-(np.float32(t0i) + np.float32(spec.t0_frac))) \
        * delta0 / codef0
    c_step = _f32(spec.t0_frac) + d_t0                         # [C]
    k = torch.arange(E + 1, dtype=f32, device=dev)
    r = rem_code[:, None] + (k[None, :] - 1.0) * c_step[:, None]
    s_pred = (start[:, None] + cur_len[:, None]
              + (k[None, :].to(i32) - 1) * t0i
              + torch.floor(r).to(i32))                        # [C, E+1]
    s_pred[:, 0] = start
    len_pred = s_pred[:, 1:] - s_pred[:, :-1]                  # [C, E]

    # --- per-channel segment -> E static epoch windows (views) ---
    off = torch.clamp(start - spec.grid_pad, 0, n_samp - spec.seg_len)
    idx = off.to(torch.int64)[:, None] + torch.arange(
        spec.seg_len, device=dev)[None, :]
    seg = samples[idx]                                         # [C, seg]
    seg_r = seg.real.unfold(1, NW, t0i)                        # [C, E, NW]
    seg_i = seg.imag.unfold(1, NW, t0i)
    s_reg = off[:, None] + (torch.arange(E, dtype=i32, device=dev)
                            * t0i)[None, :]                    # [C, E]

    # --- frozen-NCO carrier wipe-off across the chunk ---
    step0 = _f32(_TWO_PI) * (fst[tc.F_DOPPLER] + fst[tc.F_CARR_OFF]) \
        / _f32(spec.fs)
    phi_k = tc.mod_floor(
        fst[tc.F_REM_CARR][:, None]
        + step0[:, None] * (s_reg - start[:, None]).to(f32),
        _f32(_TWO_PI))                                         # [C, E]
    n = torch.arange(NW, dtype=f32, device=dev)
    phase = phi_k[..., None] + step0[:, None, None] * n
    cs, sn = torch.cos(phase), torch.sin(phase)
    # (re + j im) * (cos - j sin)
    wr = seg_r * cs + seg_i * sn
    wi = seg_i * cs - seg_r * sn
    # mask to each epoch's true content [d', d' + len_pred)
    dp = (s_pred[:, :E] - s_reg).to(f32)[..., None]            # [C, E, 1]
    mask = (n >= dp) & (n < dp + len_pred[..., None].to(f32))
    zero = torch.zeros((), dtype=f32, device=dev)
    wr = torch.where(mask, wr, zero)
    wi = torch.where(mask, wi, zero)
    return wr, wi, s_reg, step0


def correlate_plain(spec: CorrSpec, samples, bank_t, fst, ist, lowp=None):
    """windows_plain, then one batched matmul per I/Q plane against
    `bank_t` (replica_bank): [C, E, NW] x [C, NW, LW] -> [C, E, LW]."""
    wr, wi, s_reg, step0 = windows_plain(spec, samples, fst, ist)
    if lowp is not None:
        wr, wi = lowp(wr), lowp(wi)
    return torch.bmm(wr, bank_t), torch.bmm(wi, bank_t), s_reg, step0
