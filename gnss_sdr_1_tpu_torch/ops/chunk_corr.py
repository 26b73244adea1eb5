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
I/Q plane.  The kernel computes the same product on the tensor cores as
the JAX package computes it on the MXU, one matrix product per channel,
`Z[2E, LW] = W[2E, NW] . T[NW, LW]` (the I and Q planes of the E wiped
windows against the channel's Toeplitz replica), in TF32 passes that
split the samples into high and low parts; a table that is not exact in
TF32 splits too (`table_passes`).  `corr_geometry` cuts the sample range
over a cluster of CTAs per channel.

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

# kernel geometry (csrc/chunk_corr.cuh CC_*): threads (and warps) per CTA,
# the largest cluster of CTAs a channel takes, and the output block one
# pass of a CTA's accumulators covers: 32 plane-epoch rows (two m16 tiles)
# by 80 lags (ten n8 tiles: every receiver's LW, 66-73); samples per k-step
# of mma.m16n8k8
THREADS = 256
MAX_CLUSTER = 16
BLOCK_ROWS = 32
BLOCK_LAGS = 80
KSTEP = 8
# the warps as KGROUPS k-groups (k-steps g, g + KGROUPS, ...) by two
# n-groups (five n-tiles each); the k-groups' blocks meet in shared memory
# in rows of RED_STRIDE floats
KGROUPS = 4
RED_STRIDE = 88
# shared memory two CTAs may each take on one SM (228 KB an SM, 1 KB of it
# reserved per CTA): the tiles are sized to it, so the wipe of one CTA
# overlaps the product of the other
SMEM_HALF = 228 * 1024 // 2 - 1024

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


def table_passes(rows) -> int:
    """The TF32 passes the kernel takes on a replica table: 2 where every
    value is exact in TF32 (then hi(a) b + lo(a) b carries the float32
    product), 3 otherwise (hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b))."""
    bits = torch.as_tensor(np.asarray(rows, np.float32)).view(torch.int32)
    return 2 if bool(((bits & 0x1FFF) == 0).all()) else 3


@dataclasses.dataclass(frozen=True)
class CorrGeometry:
    """One launch of the kernel: a cluster of G CTAs per channel, CTA r
    taking k-steps [r SK, (r + 1) SK) of the NK = ceil(NW / 8) over the
    window, in `tiles` tiles of TK k-steps; the output in MB x NB blocks of
    32 rows by 80 lags.  Shared memory (`_layout`, `smem` bytes in all):
    the tile's raw samples, its wiped samples (32 rows of `a_stride`
    floats, `a_floats` with the k-groups' partial blocks, which take it
    over when the tiles are done), two replica stretches (`q_floats`), the
    cluster's partial sums of the outputs the CTA owns (a row a rank) and
    the epochs' geometry."""

    G: int
    NK: int
    SK: int
    TK: int
    tiles: int
    MB: int
    NB: int
    a_stride: int
    a_floats: int
    q_floats: int
    smem: int


def _layout(TK: int, E: int) -> tuple[int, int, int, int]:
    """(a_stride, a_floats, q_floats, smem bytes) for tiles of TK k-steps:
    the tile's raw samples [E][8 TK] complex, its wiped samples (32 rows of
    a_stride), two row stretches (this tile's, the next one's), the
    ranks' sums of the outputs the CTA owns, the epochs' geometry."""
    a_stride = KSTEP * TK + 4          # = 4 mod 8: A loads free of conflicts
    a_floats = max(BLOCK_ROWS * a_stride, KGROUPS * BLOCK_ROWS * RED_STRIDE)
    q_floats = _round4(KSTEP * TK + BLOCK_LAGS)
    smem = 4 * (2 * E * KSTEP * TK + a_floats + 2 * q_floats
                + BLOCK_ROWS * BLOCK_LAGS + MAX_CLUSTER + 4 * E)
    return a_stride, a_floats, q_floats, smem


def corr_geometry(E: int, LW: int, NW: int, G: int,
                  max_smem: int = SMEM_HALF) -> CorrGeometry:
    """The kernel's geometry for a window of NW samples, E epochs and LW
    lags split over a cluster of G CTAs: each CTA's k-steps in the fewest
    tiles whose shared memory fits `max_smem` bytes, of equal size."""
    if not 1 <= G <= MAX_CLUSTER:
        raise ValueError(f"a cluster takes 1 to {MAX_CLUSTER} CTAs, got {G}")
    NK = -(-NW // KSTEP)
    SK = -(-NK // G)
    tk_max = SK
    while tk_max > 1 and _layout(tk_max, E)[3] > max_smem:
        tk_max -= 1
    if _layout(tk_max, E)[3] > max_smem:
        raise ValueError(f"{E} epochs leave no room for a tile in "
                         f"{max_smem} B of shared memory")
    tiles = -(-SK // tk_max)
    TK = -(-SK // tiles)
    a_stride, a_floats, q_floats, smem = _layout(TK, E)
    return CorrGeometry(G=G, NK=NK, SK=SK, TK=TK, tiles=tiles,
                        MB=-(-2 * E // BLOCK_ROWS),
                        NB=-(-LW // BLOCK_LAGS), a_stride=a_stride,
                        a_floats=a_floats, q_floats=q_floats, smem=smem)


def fit_cluster(spec: CorrSpec, active) -> CorrGeometry:
    """The geometry on a card where `active(G, smem)` clusters of G CTAs
    with `smem` bytes each are resident at once: the largest cluster, up to
    MAX_CLUSTER and to one k-step a CTA, of which all C channels' clusters
    are resident together (one wave); else the largest the card schedules
    at all."""
    best = None
    for G in range(min(MAX_CLUSTER, -(-spec.NW // KSTEP)), 0, -1):
        geo = corr_geometry(spec.E, spec.LW, spec.NW, G)
        n = active(G, geo.smem)
        if n >= spec.C:
            return geo
        if n >= 1 and best is None:
            best = geo
    if best is None:
        raise RuntimeError("the card schedules no cluster of the chunk "
                           "correlator")
    return best


class CorrParams(ctypes.Structure):
    """Mirror of `CorrParams` in csrc/chunk_corr.cuh (passed by value to the
    kernel)."""

    _fields_ = [
        ("E", ctypes.c_int), ("LW", ctypes.c_int), ("NW", ctypes.c_int),
        ("C", ctypes.c_int), ("QW", ctypes.c_int), ("t0_int", ctypes.c_int),
        ("grid_pad", ctypes.c_int), ("seg_len", ctypes.c_int),
        ("G", ctypes.c_int), ("NK", ctypes.c_int), ("SK", ctypes.c_int),
        ("TK", ctypes.c_int), ("tiles", ctypes.c_int), ("MB", ctypes.c_int),
        ("NB", ctypes.c_int), ("a_stride", ctypes.c_int),
        ("a_floats", ctypes.c_int), ("q_floats", ctypes.c_int),
        ("passes", ctypes.c_int), ("smem", ctypes.c_int),
        ("t0_frac", ctypes.c_float), ("neg_t0", ctypes.c_float),
        ("chip_rate", ctypes.c_float), ("fs", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=32)
def corr_params(spec: CorrSpec) -> CorrParams:
    """The kernel's by-value constants for one spec on this card: the
    cluster (fit_cluster) from cudaOccupancyMaxActiveClusters, asked at
    first launch through the library's `chunk_corr_max_active`."""
    from ._build import library

    if spec.passes not in (2, 3):
        raise ValueError(f"passes must be 2 or 3, got {spec.passes}")
    geo = fit_cluster(spec, lambda G, smem: library().chunk_corr_max_active(
        G, smem, spec.passes))
    p = CorrParams()
    p.E, p.LW, p.NW, p.C, p.QW = spec.E, spec.LW, spec.NW, spec.C, spec.QW
    p.t0_int, p.grid_pad, p.seg_len = spec.t0_int, spec.grid_pad, spec.seg_len
    for name in ("G", "NK", "SK", "TK", "tiles", "MB", "NB", "a_stride",
                 "a_floats", "q_floats", "smem"):
        setattr(p, name, getattr(geo, name))
    p.passes = spec.passes
    p.t0_frac = _f32(spec.t0_frac)
    p.neg_t0 = _f32(-(np.float32(spec.t0_int) + np.float32(spec.t0_frac)))
    p.chip_rate, p.fs = _f32(spec.chip_rate), _f32(spec.fs)
    return p


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
    """Launch the CUDA kernel once (a cluster of CTAs per channel)."""
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
