"""The per-epoch gather DLL/PLL walk of a capture segment: the CUDA kernel,
its plain torch version and the wrapper that picks between them by the
device of its inputs.

For every epoch of every channel, in order (the JAX package's
`_epoch_step`, gnss_sdr_1_tpu/track/engine.py:786-824, run by its gather
branches at :1171 and :1486): the window origin `m` (the minimum start of
the active channels, clipped to `[0, n_samp - win]`) and each channel's
offset from it, clipped to `[0, win - n_max]` (the gather path never pads
the capture, so near its end the clip moves the window); the exact gather
multicorrelator (A.1/A.2, ops.multicorrelator: the carrier wiped with
`cp + cs n`, the code index `floor(step n + shift - rem) mod L`, K taps);
then the chain's loop closure (ops.track_chain `loop_close_plain`, JAX
`_loop_update`), with the secondary wipe in the closure and the GLONASS
FDMA carrier offset in the carrier step.

The JAX package runs this as an XLA loop on every backend but the TPU; it
is not a Pallas kernel.  The kernel (csrc/gather_block.cu, with the
correlation in csrc/gather_corr.cuh and the closure in csrc/loop_close.cuh)
walks the segment in one launch of one thread-block cluster, one CTA per
channel; `gather_geometry` computes the launch's shape and shared memory,
which the C entry checks.

State crosses the call in the chain's rows (ops.track_chain F_* / I_*,
`n_frows(K)` x C float32 and N_IROWS x C int32), and the per-epoch outputs
are the chain's rows too, so the engine's packing and reductions serve both
correlators.

Signature of `gather_block` / `gather_block_plain`:
    (spec, samples [n_samp] complex64, codes [C, L] f32 (+-1, the
     channels' code rows), sec_rows [sec_len, C] f32, fst [SF, C] f32,
     ist [SI, C] i32, n_epochs)
 -> (out_f [n_epochs, N_OROWS, C] f32, out_i [n_epochs, 2, C] i32,
     out_corr [n_epochs, 2K, C] f32, fst' [SF, C] f32, ist' [SI, C] i32)
An epoch runs where its channel is active and starts before the limit
row `ist[I_LIMIT]`; starts stay relative to the capture.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .cluster_walk import (ClusterGeometry, cluster_geometry, fit_to_card,
                           prefetch_bytes, round16)
from .multicorrelator import multicorrelate
from .track_chain import (F_CARR_OFF, F_DELTA, F_DOPPLER, F_REM_CARR,
                          F_REM_CODE, I_ACTIVE, I_CURLEN, I_START, MAX_K,
                          N_IROWS, N_OROWS, ChainSpec, _f32, chain_params,
                          check_tensor, loop_close_plain, loop_consts_plain,
                          n_frows)

_TWO_PI = float(2.0 * np.pi)

# kernel launches made by `gather_block` on CUDA tensors (never by
# gather_block_plain)
launches = 0


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
                       n_epochs: int):
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
                              cs, 0.0, i[I_CURLEN].to(f32))    # [C, K]
        f, i, out_f[e], out_i[e], out_corr[e], _ = loop_close_plain(
            spec.loop, consts, f, i, [corr[:, k].real for k in range(K)],
            [corr[:, k].imag for k in range(K)], sec_rows)
    return out_f, out_i, out_corr, f, i


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/gather_block.cu)
# ---------------------------------------------------------------------------

# launch geometry: threads per CTA (== the kernel's __launch_bounds__) and
# the largest cluster the kernel asks for (the portable cluster size and
# the shared memory a CTA may use are ops/cluster_walk.py's)
GB_THREADS = 256
GB_WARPS = GB_THREADS // 32
GB_MAX_CLUSTER = 16


def gather_layout(cpc: int, K: int, n_max: int, code_len: int, sec_len: int,
                  prefetch: bool) -> dict:
    """Byte offsets of one CTA's dynamic shared memory, as gather_block.cu
    `gb_layout` computes them: the mbarriers, the two m slots, the prefetch
    records, the prefetch buffers, the code bits, the state rows, the
    secondary chips and the warp partial sums; `total` is the launch's
    dynamic shared memory."""
    W = (code_len + 31) // 32
    lay = {"bar": 0, "slot": 8 * cpc}
    lay["info"] = lay["slot"] + 8
    lay["pf"] = round16(lay["info"] + 16 * cpc)
    lay["bits"] = lay["pf"] + (cpc * prefetch_bytes(n_max) if prefetch
                               else 0)
    lay["sf"] = lay["bits"] + 4 * cpc * W
    lay["si"] = lay["sf"] + 4 * n_frows(K) * cpc
    lay["sec"] = lay["si"] + 4 * N_IROWS * cpc
    lay["part"] = lay["sec"] + 4 * sec_len * cpc
    lay["total"] = lay["part"] + 4 * 2 * GB_WARPS * 2 * K
    return lay


def gather_geometry(C: int, K: int, n_max: int, code_len: int, sec_len: int,
                    max_cluster: int) -> ClusterGeometry:
    """The launch geometry of C channels when the card schedules clusters
    of up to `max_cluster` CTAs."""
    if K not in (3, 5):
        raise ValueError("the gather kernel takes K=3 or K=5 taps")
    return cluster_geometry(
        C, n_max, GB_THREADS, max_cluster, GB_MAX_CLUSTER,
        lambda cpc, pf: gather_layout(cpc, K, n_max, code_len, sec_len,
                                      pf)["total"],
        f"{code_len} code samples")


@functools.lru_cache(maxsize=64)
def launch_geometry(spec: GatherSpec) -> ClusterGeometry:
    """The geometry of the spec's launch on this card: the largest cluster
    it schedules (cudaOccupancyMaxActiveClusters, asked at first launch)
    for the shared memory the geometry needs."""
    from ._build import gather_library

    return fit_to_card(
        lambda n: gather_geometry(spec.C, spec.K, spec.n_max, spec.code_len,
                                  spec.loop.sec_len, n),
        lambda smem: gather_library().gather_block_max_cluster(spec.K, smem),
        GB_MAX_CLUSTER)


class GatherParams(ctypes.Structure):
    """Mirror of `GatherParams` in csrc/gather_block.cu (copied by the C
    entry; every float is the float32 value the plain version uses)."""

    _fields_ = [
        ("C", ctypes.c_int), ("K", ctypes.c_int), ("n_max", ctypes.c_int),
        ("win", ctypes.c_int), ("code_len", ctypes.c_int),
        ("sec_len", ctypes.c_int), ("n_samp", ctypes.c_int),
        ("n_epochs", ctypes.c_int),
        ("chip_rate", ctypes.c_float), ("inv_fs", ctypes.c_float),
        ("spc", ctypes.c_float), ("two_pi", ctypes.c_float),
        ("shifts", ctypes.c_float * MAX_K),
        ("n_cta", ctypes.c_int), ("cpc", ctypes.c_int),
        ("threads", ctypes.c_int), ("prefetch", ctypes.c_int),
        ("pf_bytes", ctypes.c_int), ("smem", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=64)
def gather_params(spec: GatherSpec, n_samp: int, n_epochs: int,
                  geo: ClusterGeometry) -> GatherParams:
    """The kernel's constants for one spec, sample count, epoch count and
    geometry (built once)."""
    if geo.C != spec.C:
        raise ValueError(f"geometry of {geo.C} channels for {spec.C}")
    p = GatherParams()
    p.C, p.K, p.n_max, p.win = spec.C, spec.K, spec.n_max, spec.win
    p.code_len, p.sec_len = spec.code_len, spec.loop.sec_len
    p.n_samp, p.n_epochs = int(n_samp), int(n_epochs)
    p.chip_rate, p.inv_fs = _f32(spec.loop.chip_rate), spec.inv_fs
    p.spc, p.two_pi = _f32(spec.spc), _f32(_TWO_PI)
    for k in range(spec.K):
        p.shifts[k] = _f32(spec.shifts[k])
    for name in ("n_cta", "cpc", "threads", "pf_bytes", "smem"):
        setattr(p, name, int(getattr(geo, name)))
    p.prefetch = int(geo.prefetch)
    return p


def check_inputs(spec: GatherSpec, samples, codes, sec_rows, fst, ist):
    """Device, dtype, shape and contiguity of the kernel's inputs."""
    C, K = spec.C, spec.K
    if samples.dim() != 1 or samples.shape[0] < spec.n_max:
        raise ValueError(f"samples must be [>= {spec.n_max}], got "
                         f"{tuple(samples.shape)}")
    check_tensor(samples, "samples", samples.shape, torch.complex64)
    check_tensor(codes, "codes", (C, spec.code_len), torch.float32)
    check_tensor(sec_rows, "sec_rows", (spec.loop.sec_len, C),
                 torch.float32)
    check_tensor(fst, "fst", (n_frows(K), C), torch.float32)
    check_tensor(ist, "ist", (N_IROWS, C), torch.int32)


def gather_block_cuda(spec: GatherSpec, samples, codes, sec_rows, fst, ist,
                      n_epochs: int):
    """Launch the CUDA kernel once for n_epochs epochs, as one cluster
    (launch_geometry).  The code rows must be +-1 (the kernel keeps them
    as bits; the engine's tables are)."""
    global launches
    from ._build import gather_library

    check_inputs(spec, samples, codes, sec_rows, fst, ist)
    C, K = spec.C, spec.K
    f32 = torch.float32
    dev = samples.device
    out_f = torch.empty((n_epochs, N_OROWS, C), dtype=f32, device=dev)
    out_i = torch.empty((n_epochs, 2, C), dtype=torch.int32, device=dev)
    out_corr = torch.empty((n_epochs, 2 * K, C), dtype=f32, device=dev)
    fst_out = torch.empty_like(fst)
    ist_out = torch.empty_like(ist)
    geo = launch_geometry(spec)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = gather_library().gather_block_launch(
        samples.data_ptr(), codes.data_ptr(), sec_rows.data_ptr(),
        fst.data_ptr(), ist.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
        out_corr.data_ptr(), fst_out.data_ptr(), ist_out.data_ptr(),
        ctypes.addressof(chain_params(spec.loop)),
        ctypes.addressof(gather_params(spec, int(samples.shape[0]),
                                       int(n_epochs), geo)), stream)
    if err != 0:
        raise RuntimeError(f"gather_block kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out_f, out_i, out_corr, fst_out, ist_out


def gather_block(spec: GatherSpec, samples, codes, sec_rows, fst, ist,
                 n_epochs: int):
    """Walk the epochs where the inputs lie: the CUDA kernel for CUDA
    tensors, the plain torch version for CPU tensors."""
    devs = {t.device.type for t in (samples, codes, sec_rows, fst, ist)}
    if devs == {"cuda"}:
        return gather_block_cuda(spec, samples, codes, sec_rows, fst, ist,
                                 n_epochs)
    if devs == {"cpu"}:
        return gather_block_plain(spec, samples, codes, sec_rows, fst, ist,
                                  n_epochs)
    raise ValueError(f"gather_block inputs must all lie on one device type, "
                     f"got {sorted(devs)}")
