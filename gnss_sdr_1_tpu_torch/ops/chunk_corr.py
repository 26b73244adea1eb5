"""Fused chunk correlator: window, carrier wipe-off and lag correlation of
one tracking chunk.  The CUDA kernel, its plain torch version and the
wrapper that picks between them by the device of its inputs.

For each channel `c`, epoch `e < E` and lag `l < LW`, on the regular epoch
grid with the chunk-entry (frozen) NCO:

    off[c]     = clamp(start[c] - grid_pad, 0, n_samp - seg_len)
    s_reg[c,e] = off[c] + e * t0_int
    s_pred, len_pred: the epoch starts and lengths predicted under the
                 frozen code frequency
    step0[c]   = f32(2 pi) * (doppler[c] + carr_off[c]) / f32(fs)
    phi[c,e]   = mod_floor(rem_carr[c] + step0[c] * (s_reg[c,e] - start[c]),
                           2 pi)
    w[n]       = x[s_reg[c,e] + n] * exp(-j (phi[c,e] + step0[c] * n)),
                 kept where dp <= n < dp + len_pred[c,e], dp = s_pred - s_reg
    z[c,e,l]   = sum_{n < NW} w[n] * R[slot[c], l, n]

`R[s, l, n] = code[s, floor(a0 (n - l + margin)) mod L]` depends on `n - l`
only, so the kernel reads one replica row per slot (the Toeplitz table
`rows[s, n - l + LW - 1]`, built by the engine).  The plain version expands
the rows into the per-channel bank and correlates with one `torch.bmm` per
I/Q plane.

It replaces the XLA stages of the JAX package's chunked engine
(gnss_sdr_1_tpu/track/engine.py `_chunk_windows` and the two `einsum`s of
`_pallas_chunk`); the output feeds the tracking chain (ops.track_chain).

Signature of `chunk_corr` / `chunk_corr_plain`:
    (spec, samples [n_samp] complex64 (zero-padded capture),
     rows [n_slots, QW] f32, slot [C] i32, fst [SF,C] f32, ist [SI,C] i32)
 -> (zr [C,E,LW] f32, zi [C,E,LW] f32, s_reg [C,E] i32, step0 [C] f32)
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import track_chain as tc

_TWO_PI = float(2.0 * np.pi)

# kernel geometry (csrc/chunk_corr.cuh): lags per thread, threads per
# block, zero floats left of the staged replica row
TL = 17
THREADS = 256
PADL = 32
MAX_SMEM = 232448          # bytes a block may use on Hopper

# kernel launches made by `chunk_corr` / the capture entry on CUDA tensors
# (never by chunk_corr_plain)
launches = 0


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


def correlate_plain(spec: CorrSpec, samples, bank_t, fst, ist):
    """windows_plain, then one batched matmul per I/Q plane against
    `bank_t` (replica_bank): [C, E, NW] x [C, NW, LW] -> [C, E, LW]."""
    wr, wi, s_reg, step0 = windows_plain(spec, samples, fst, ist)
    return torch.bmm(wr, bank_t), torch.bmm(wi, bank_t), s_reg, step0


def chunk_corr_plain(spec: CorrSpec, samples, rows, slot, fst, ist):
    """The chunk correlator in plain torch ops (any device)."""
    return correlate_plain(spec, samples, replica_bank(spec, rows, slot),
                           fst, ist)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/chunk_corr.cuh, built into the track_chain library)
# ---------------------------------------------------------------------------


class CorrParams(ctypes.Structure):
    """Mirror of `CorrParams` in csrc/chunk_corr.cuh (passed by value to the
    kernel)."""

    _fields_ = [
        ("E", ctypes.c_int), ("LW", ctypes.c_int), ("NW", ctypes.c_int),
        ("C", ctypes.c_int), ("QW", ctypes.c_int), ("t0_int", ctypes.c_int),
        ("grid_pad", ctypes.c_int), ("seg_len", ctypes.c_int),
        ("tl", ctypes.c_int), ("threads", ctypes.c_int),
        ("padl", ctypes.c_int), ("S", ctypes.c_int), ("L", ctypes.c_int),
        ("tiles", ctypes.c_int), ("wbuf", ctypes.c_int), ("qs", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("t0_frac", ctypes.c_float), ("neg_t0", ctypes.c_float),
        ("chip_rate", ctypes.c_float), ("fs", ctypes.c_float),
    ]


def _smem_floats(S: int, L: int, NG: int, LW: int) -> tuple[int, int]:
    """(wbuf, qs): floats of the wiped-sample buffer (reused for the
    partial sums) and of the staged replica row for one tile of S * L
    samples."""
    SL = S * L
    return (_round4(max(2 * SL, 2 * S * NG * TL)),
            _round4(PADL + SL + LW - 1))


@functools.lru_cache(maxsize=32)
def corr_params(spec: CorrSpec, max_smem: int = MAX_SMEM) -> CorrParams:
    """The kernel's by-value constants and block geometry for one spec.

    Threads own TL consecutive lags (NG lag groups cover LW) and split each
    tile of the n range into S slices of L samples (L a multiple of TL).
    Shared memory: the tile's wiped samples as (re, im) pairs, reused for
    the per-slice partial sums, then the tile's stretch of the replica row
    after PADL zeros, long enough for every index n - l + LW - 1 the slices
    read.  One tile covers the window when that fits in `max_smem` bytes;
    otherwise the window is walked in `tiles` tiles of S * L samples (L a
    multiple of 4 TL, so that every tile's row stretch starts 16-byte
    aligned) and each thread carries its lag sums from tile to tile."""
    NG = -(-spec.LW // TL)
    S = THREADS // NG
    if S < 1:
        raise ValueError(f"lag window {spec.LW} too long for the correlator")
    L = -(-spec.NW // (S * TL)) * TL
    tiles = 1
    if 4 * sum(_smem_floats(S, L, NG, spec.LW)) > max_smem:
        step = 4 * TL
        l_max = step
        while 4 * sum(_smem_floats(S, l_max + step, NG, spec.LW)) <= max_smem:
            l_max += step
        if 4 * sum(_smem_floats(S, l_max, NG, spec.LW)) > max_smem:
            raise ValueError(f"lag window {spec.LW} leaves no room for a "
                             f"tile in {max_smem} B of shared memory")
        tiles = -(-spec.NW // (S * l_max))
        L = -(-spec.NW // (tiles * S * step)) * step
    wbuf, qs = _smem_floats(S, L, NG, spec.LW)
    p = CorrParams()
    p.E, p.LW, p.NW, p.C, p.QW = spec.E, spec.LW, spec.NW, spec.C, spec.QW
    p.t0_int, p.grid_pad, p.seg_len = spec.t0_int, spec.grid_pad, spec.seg_len
    p.tl, p.threads, p.padl = TL, NG * S, PADL
    p.S, p.L, p.tiles, p.wbuf, p.qs = S, L, tiles, wbuf, qs
    p.smem_bytes = 4 * (wbuf + qs)
    p.t0_frac = _f32(spec.t0_frac)
    p.neg_t0 = _f32(-(np.float32(spec.t0_int) + np.float32(spec.t0_frac)))
    p.chip_rate, p.fs = _f32(spec.chip_rate), _f32(spec.fs)
    return p


def correlate_tiles_plain(spec: CorrSpec, samples, rows, slot, fst, ist,
                          p: CorrParams):
    """The kernel's tile walk in plain torch ops: for each tile of S * L
    samples, the replica stretch staged as the kernel stages it (PADL zeros,
    the row from the tile's first sample, zeros past the row's end) and the
    tile's lag sums added to the running ones.  Equal to chunk_corr_plain
    up to the order of the sums; the tests hold the tiling to it."""
    wr, wi, s_reg, step0 = windows_plain(spec, samples, fst, ist)
    dev = samples.device
    C, E, LW, NW = spec.C, spec.E, spec.LW, spec.NW
    SL = p.S * p.L
    q_rows = rows[slot.long()]                                 # [C, QW]
    zr = torch.zeros((C, E, LW), dtype=torch.float32, device=dev)
    zi = torch.zeros_like(zr)
    nl = torch.arange(SL, device=dev)
    idx = nl[:, None] - torch.arange(LW, device=dev)[None, :] \
        + LW - 1 + p.padl                                      # [SL, LW]
    for t in range(p.tiles):
        n0 = t * SL
        nq = min(spec.QW - n0, p.qs - p.padl)
        q = torch.zeros((C, p.qs), dtype=torch.float32, device=dev)
        q[:, p.padl:p.padl + nq] = q_rows[:, n0:n0 + nq]
        bank = q[:, idx]                                       # [C, SL, LW]
        w_r = torch.zeros((C, E, SL), dtype=torch.float32, device=dev)
        w_i = torch.zeros_like(w_r)
        n1 = min(NW, n0 + SL)
        w_r[..., :n1 - n0] = wr[..., n0:n1]
        w_i[..., :n1 - n0] = wi[..., n0:n1]
        zr = zr + torch.bmm(w_r, bank)
        zi = zi + torch.bmm(w_i, bank)
    return zr, zi, s_reg, step0


def check_inputs(spec: CorrSpec, samples, rows, slot, fst, ist, n_frows):
    """Device, dtype, shape and contiguity of the kernel's inputs (`fst`
    with `n_frows` rows)."""
    if samples.dim() != 1 or samples.shape[0] < spec.seg_len:
        raise ValueError(f"samples must be 1-D with >= {spec.seg_len} "
                         f"samples")
    tc.check_tensor(samples, "samples", tuple(samples.shape),
                    torch.complex64)
    tc.check_tensor(rows, "rows", (rows.shape[0], spec.QW), torch.float32)
    tc.check_tensor(slot, "slot", (spec.C,), torch.int32)
    tc.check_tensor(fst, "fst", (n_frows, spec.C), torch.float32)
    tc.check_tensor(ist, "ist", (tc.N_IROWS, spec.C), torch.int32)
    if samples.shape[0] >= 2 ** 31:
        raise ValueError("capture too long for int32 sample indices")


def chunk_corr_cuda(spec: CorrSpec, samples, rows, slot, fst, ist):
    """Launch the CUDA kernel once (one block per channel and epoch)."""
    global launches
    from ._build import library

    if fst.dim() != 2 or fst.shape[0] <= tc.F_CARR_OFF:
        raise ValueError(f"fst must hold the state rows up to "
                         f"{tc.F_CARR_OFF}")
    check_inputs(spec, samples, rows, slot, fst, ist, fst.shape[0])
    C, E, LW = spec.C, spec.E, spec.LW
    dev = samples.device
    zr = torch.empty((C, E, LW), dtype=torch.float32, device=dev)
    zi = torch.empty((C, E, LW), dtype=torch.float32, device=dev)
    s_reg = torch.empty((C, E), dtype=torch.int32, device=dev)
    step0 = torch.empty((C,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().chunk_corr_launch(
        samples.data_ptr(), samples.shape[0], rows.data_ptr(),
        slot.data_ptr(), fst.data_ptr(), ist.data_ptr(), zr.data_ptr(),
        zi.data_ptr(), s_reg.data_ptr(), step0.data_ptr(),
        ctypes.addressof(corr_params(spec)), stream)
    if err != 0:
        raise RuntimeError(f"chunk_corr kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return zr, zi, s_reg, step0


def chunk_corr(spec: CorrSpec, samples, rows, slot, fst, ist):
    """Run the correlator where its inputs lie: the CUDA kernel for CUDA
    tensors, the plain torch version for CPU tensors."""
    devs = {t.device.type for t in (samples, rows, slot, fst, ist)}
    if devs == {"cuda"}:
        return chunk_corr_cuda(spec, samples, rows, slot, fst, ist)
    if devs == {"cpu"}:
        return chunk_corr_plain(spec, samples, rows, slot, fst, ist)
    raise ValueError(f"chunk_corr inputs must all lie on one device type, "
                     f"got {sorted(devs)}")
