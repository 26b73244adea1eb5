"""Gather multicorrelator: carrier wipe-off + code resampling + K-tap dot
products, in plain torch ops (any device).

Reference parity: volk_gnsssdr_32fc_32f_rotator_dot_prod_32fc_xn.h
(rotator + multi-dot product, SURVEY.md A.1) fused with
volk_gnsssdr_32f_xn_resampler_32f_xn.h (floor code resampler, A.2), as
driven by cpu_multicorrelator_real_codes.cc:129-169.  The JAX package
computes it in XLA (no Pallas kernel).  `multicorrelate` is the plain
version (the KF and gather walks call it per epoch); `multicorrelate_cuda`
runs one epoch of C channels as one hand kernel (csrc/multicorrelate.cuh:
a cluster of CTAs a channel, the samples bulk-copied into shared memory,
the CTAs' sums added in rank order over distributed shared memory, the
per-channel arguments by value in the parameter block or by pointer), and
`correlate` picks between them by the device of the samples (the TCP
connector's per-epoch call).

Numerical contracts:
  * code index: idx = floor(code_phase_step*n + shift_k - rem_code_phase)
    mod L  (nearest-previous-sample, no interpolation; `mod` takes the sign
    of the divisor, as jnp.mod does)
  * carrier: out[k] = sum_n in[n] * exp(-j(phi + dphi*n + 0.5*ddphi*n^2))
    * code_k[n], the phase evaluated directly in float32
  * the multiply-adds of the phase and the code index round once (fused),
    as the reference's compiled expressions do
  * masking: sample n participates iff n < n_valid (variable integration
    block length, d_current_prn_length_samples).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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
    wr = samples.real * c + samples.imag * s
    wi = samples.imag * c - samples.real * s
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


def multicorrelate_batch(
    samples, code, shifts_chips, code_phase_step, rem_code_phase,
    carr_phase_rad, carr_step_rad, carr_rate_rad, n_valid,
):
    """Channel-batched multicorrelator: leading axis C on samples, code and
    all scalar loop parameters; shared tap shifts (`multicorrelate`
    batches every leading axis)."""
    return multicorrelate(
        samples, code, shifts_chips, code_phase_step, rem_code_phase,
        carr_phase_rad, carr_step_rad, carr_rate_rad, n_valid,
    )


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/multicorrelate.cuh): one epoch, C channels, a cluster of
# G CTAs each
# ---------------------------------------------------------------------------

MC_THREADS = 256
MC_WARPS = MC_THREADS // 32
MC_MAX_K = 5
# channels whose per-channel values the parameter block holds by value
MC_MAX_C = 32
# the largest cluster a channel takes, and the samples a CTA aims at
MC_MAX_CLUSTER = 16
MC_SLICE = 512
# the per-channel arguments, in the block's order (multicorrelate.cuh
# MC_STEP .. MC_NV); all float32 but n_valid (int32)
MC_ARGS = ("step", "rem", "cp", "cs", "cr", "n_valid")
MC_CR = MC_ARGS.index("cr")
# a CTA's timeline in the MC_STAGES build (multicorrelate.cuh MC_T_*)
T_START, T_ISSUED, T_PACKED, T_READY, T_CORR, T_CTA, T_DONE, T_SAMPLES = \
    range(8)
STAGE_POINTS = 8
# the stage build's probes: what the per-sample body leaves out
PROBE_SINCOS, PROBE_TAPS, PROBE_F32 = 1, 2, 4

# kernel launches made by `multicorrelate_cuda` (never by multicorrelate)
launches = 0


class McParams(ctypes.Structure):
    """Mirror of `McParams` in csrc/multicorrelate.cuh (its static_asserts
    state the offsets).  dev[a]: the address of argument a's [C] values on
    the card (element stride stride[a], 0 for one value for every
    channel), or 0: then val[a] (n_valid for the last) holds them."""

    _fields_ = [("dev", ctypes.c_void_p * len(MC_ARGS)),
                ("stride", ctypes.c_int * len(MC_ARGS)),
                ("C", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("L", ctypes.c_int), ("order", ctypes.c_int),
                ("G", ctypes.c_int), ("slice", ctypes.c_int),
                ("smem", ctypes.c_int), ("probe", ctypes.c_int),
                ("shifts", ctypes.c_float * MC_MAX_K),
                ("val", (ctypes.c_float * MC_MAX_C) * (len(MC_ARGS) - 1)),
                ("n_valid", ctypes.c_int * MC_MAX_C)]


@functools.lru_cache(maxsize=64)
def mc_geometry(N: int) -> tuple[int, int]:
    """(G, S): the CTAs of a channel's cluster and the samples of each
    CTA's slice for rows of N samples, about MC_SLICE a CTA."""
    G = min(MC_MAX_CLUSTER, max(1, -(-N // MC_SLICE)))
    return G, -(-N // G)


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def mc_layout(K: int, G: int, L: int, S: int) -> dict:
    """Byte offsets of a CTA's dynamic shared memory, as multicorrelate.cuh
    `mc_layout` computes them: the mbarrier, the warps' sums, the ranks'
    sums, the code bits, the slice; `total` is the launch's."""
    lay = {"bar": 0, "part": 16}
    lay["cl"] = lay["part"] + _round16(4 * MC_WARPS * 2 * K)
    lay["bits"] = lay["cl"] + _round16(4 * G * 2 * K)
    lay["buf"] = lay["bits"] + _round16(4 * ((L + 31) // 32))
    lay["total"] = lay["buf"] + _round16(8 * (S + 1))
    return lay


@functools.lru_cache(maxsize=64)
def _smem(K: int, G: int, L: int, S: int) -> int:
    return mc_layout(K, G, L, S)["total"]


def _host_values(v, C: int, name: str) -> np.ndarray:
    """[C] float64 of a per-channel argument held on the host."""
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size not in (1, C):
        raise ValueError(f"{name} takes one value or one per channel "
                         f"({C}), got {a.size}")
    return np.broadcast_to(a, (C,))


def pack_params(C: int, N: int, L: int, shifts, args, dev: torch.device,
                geometry: tuple[int, int] | None = None, probe: int = 0):
    """The launch's parameter block for C rows of N samples, code rows of
    L chips and the K tap `shifts` (host numbers): each of `args` (MC_ARGS'
    order; n_valid None = N) that is a tensor on `dev` goes by pointer,
    float32 (int32 for n_valid), converted on `dev` where it is not, its
    stride 0 when it holds one value; anything else (Python numbers,
    sequences, numpy arrays, tensors elsewhere but on another card) by
    value: floats rounded to float32, n_valid the count of n < it clipped
    to [0, N], at most MC_MAX_C channels.  The order is 3 where the rate
    is a tensor on `dev` (order 3 gives order 2's bits at a zero rate) or
    a non-zero host value.  `geometry`: (G, S) in place of
    mc_geometry(N).  Returns (the block, the tensors it points into)."""
    K = len(shifts)
    if K not in (3, 5):
        raise ValueError(f"the kernel takes K=3 or 5 taps, got K={K}")
    G, S = mc_geometry(N) if geometry is None else geometry
    p = McParams(C=C, K=K, N=N, L=L, G=G, slice=S, probe=probe,
                 smem=_smem(K, G, L, S))
    for k, v in enumerate(shifts):
        p.shifts[k] = v           # a C float: rounded as np.float32 rounds
    keep = []
    order = 2
    nv = len(MC_ARGS) - 1
    for a, v in enumerate(args):
        if isinstance(v, torch.Tensor) and v.device.type == dev.type:
            if v.device != dev:
                raise ValueError(f"{MC_ARGS[a]} lies on {v.device}, the "
                                 f"samples on {dev}")
            if v.dim() > 1 or v.numel() not in (1, C):
                raise ValueError(f"{MC_ARGS[a]} takes one value or one per "
                                 f"channel ({C}), got {tuple(v.shape)}")
            t = v.reshape(-1)
            if a == nv and t.is_floating_point():
                t = torch.ceil(t)
            t = t.to(torch.int32 if a == nv else _F32)
            p.dev[a] = t.data_ptr()
            p.stride[a] = t.stride(0) if t.numel() == C and C > 1 else 0
            keep.append(t)
            order = 3 if a == MC_CR else order
            continue
        if C > MC_MAX_C:
            raise ValueError(f"{MC_ARGS[a]} by value holds at most "
                             f"{MC_MAX_C} channels; pass a [C] tensor on "
                             f"{dev} for {C}")
        if a == nv:
            vals = [N] * C if v is None else np.clip(
                np.ceil(_host_values(v, C, MC_ARGS[a])), 0, N).astype(int)
            for c in range(C):
                p.n_valid[c] = int(vals[c])
            continue
        row = p.val[a]
        if type(v) is float or type(v) is int:
            for c in range(C):
                row[c] = v
            order = 3 if a == MC_CR and v != 0 else order
        else:
            vals = _host_values(v, C, MC_ARGS[a])
            for c in range(C):
                row[c] = float(vals[c])
            order = 3 if a == MC_CR and np.any(vals != 0) else order
    p.order = order
    return p, keep


def _host_shifts(shifts_chips) -> list[float]:
    """The tap offsets as Python floats (a tensor is read back)."""
    if isinstance(shifts_chips, (tuple, list)):
        return [float(v) for v in shifts_chips]
    if torch.is_tensor(shifts_chips):
        shifts_chips = shifts_chips.detach().cpu().numpy()
    return [float(v) for v in np.asarray(shifts_chips, np.float64).reshape(-1)]


def _launch(library, samples, code, shifts_chips, args, stages=None,
            geometry=None, probe=0):
    """One multicorrelate_launch of the library `library()` loads, once the
    inputs are checked; returns the taps, [C, K] ([K] for one row of
    samples)."""
    dev = samples.device
    if dev.type != "cuda" or code.device != dev:
        raise ValueError("multicorrelate_cuda takes CUDA tensors")
    if samples.dtype != torch.complex64 or code.dtype != _F32:
        raise ValueError("samples must be complex64 and code float32")
    one = samples.dim() == 1
    C, N = (1, samples.shape[0]) if one else samples.shape
    if samples.dim() > 2 or code.dim() > 2 or (
            code.shape[0] if code.dim() == 2 else 1) != C:
        raise ValueError(f"the kernel takes [C, N] samples and a code row "
                         f"per channel, got samples {tuple(samples.shape)}, "
                         f"codes {tuple(code.shape)}")
    shifts = _host_shifts(shifts_chips)
    p, keep = pack_params(C, N, code.shape[-1], shifts, args, dev, geometry,
                          probe)
    x = samples if samples.is_contiguous() else samples.contiguous()
    codes = code if code.is_contiguous() else code.contiguous()
    out = torch.empty((len(shifts),) if one else (C, len(shifts)),
                      dtype=torch.complex64, device=dev)
    err = library().multicorrelate_launch(
        x.data_ptr(), codes.data_ptr(), out.data_ptr(),
        None if stages is None else stages.data_ptr(), ctypes.addressof(p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"multicorrelate kernel launch failed: CUDA error "
                           f"{err}")
    del keep
    return out


def multicorrelate_cuda(samples, code, shifts_chips, code_phase_step,
                        rem_code_phase, carr_phase_rad, carr_step_rad,
                        carr_rate_rad=0.0, n_valid=None):
    """`multicorrelate` as one kernel launch for CUDA tensors: `samples`
    [C, N] (or [N]) complex64 and `code` [C, L] (or [L]) +-1 float32 on the
    card, K = 3 or 5 taps (host numbers); the per-channel arguments Python
    numbers or host arrays (by value, up to MC_MAX_C channels: nothing is
    uploaded) or scalar or [C] tensors on the card (by pointer).  Never
    synchronises.  Returns complex64 [C, K] (or [K]) on the card."""
    global launches
    from ._build import gather_library

    out = _launch(gather_library, samples, code, shifts_chips,
                  (code_phase_step, rem_code_phase, carr_phase_rad,
                   carr_step_rad, carr_rate_rad, n_valid))
    launches += 1
    return out


def multicorrelate_stages(samples, code, shifts_chips, code_phase_step,
                          rem_code_phase, carr_phase_rad, carr_step_rad,
                          carr_rate_rad=0.0, n_valid=None, geometry=None,
                          probe=0):
    """`multicorrelate_cuda` through the MC_STAGES build (not counted in
    `launches`): (out [C, K], the timeline int64 [C G, STAGE_POINTS] on the
    card).  `geometry` (G, S) in place of mc_geometry's; `probe` a mask of
    PROBE_* (the taps are then wrong)."""
    from ._build import mc_stage_library

    C = 1 if samples.dim() == 1 else samples.shape[0]
    G, _ = mc_geometry(samples.shape[-1]) if geometry is None else geometry
    tl = torch.zeros((C * G, STAGE_POINTS), dtype=torch.int64,
                     device=samples.device)
    out = _launch(mc_stage_library, samples, code, shifts_chips,
                  (code_phase_step, rem_code_phase, carr_phase_rad,
                   carr_step_rad, carr_rate_rad, n_valid), tl, geometry,
                  probe)
    return out, tl


def multicorrelate_empty(samples, code, shifts_chips, n_valid=None):
    """An empty kernel launched in the geometry multicorrelate_cuda gives
    these inputs (the floor a launch of that shape cannot beat); not
    counted in `launches`."""
    from ._build import gather_library

    x = samples[None] if samples.dim() == 1 else samples
    codes = code[None] if code.dim() == 1 else code
    p, keep = pack_params(x.shape[0], x.shape[1], codes.shape[-1],
                          _host_shifts(shifts_chips),
                          (0.0, 0.0, 0.0, 0.0, 0.0, n_valid), x.device)
    err = gather_library().multicorrelate_empty_launch(
        ctypes.addressof(p), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def stage_split(tl, ms: float | None = None) -> dict:
    """Read an MC_STAGES timeline (int64 [C G, STAGE_POINTS]; each CTA's
    stamps on its own SM's clock, so only spans within a CTA are taken):
    per CTA in cycles, averaged over the CTAs, the copy's issue (with the
    head and tail loads), the code packing, the wait for every warp's bits
    and the copy, thread 0's correlation, the CTA's reduction and the
    cluster's (to the taps on rank 0, the barrier on the others); thread
    0's cycles a sample.  `ms`, the launch's device time, turns cycles
    into us over the longest CTA's span."""
    t = np.asarray(tl, np.float64)
    spans = {"issue": t[:, T_ISSUED] - t[:, T_START],
             "pack": t[:, T_PACKED] - t[:, T_ISSUED],
             "wait": t[:, T_READY] - t[:, T_PACKED],
             "correlation": t[:, T_CORR] - t[:, T_READY],
             "cta_reduce": t[:, T_CTA] - t[:, T_CORR],
             "cluster_reduce": t[:, T_DONE] - t[:, T_CTA]}
    total = t[:, T_DONE] - t[:, T_START]
    samples = t[:, T_SAMPLES]
    busy = samples > 0
    out = {"ctas": len(t),
           "cycles": {k: float(v.mean()) for k, v in spans.items()},
           "total_cycles": float(total.mean()),
           "max_total_cycles": float(total.max()),
           "ordered": bool(min(float(v.min()) for v in spans.values()) >= 0),
           "samples_thread0": float(samples.mean()),
           "cycles_per_sample": float(
               (spans["correlation"][busy] / samples[busy]).mean())
           if busy.any() else 0.0}
    if ms is not None:
        out["mhz"] = out["max_total_cycles"] / (ms * 1e3)
    return out


def correlate(samples, code, shifts_chips, code_phase_step, rem_code_phase,
              carr_phase_rad, carr_step_rad, carr_rate_rad=0.0,
              n_valid=None):
    """The multicorrelator where `samples` lies: the CUDA kernel on the
    card, the plain `multicorrelate` on the CPU."""
    fn = multicorrelate_cuda if samples.device.type == "cuda" \
        else multicorrelate
    return fn(samples, code, shifts_chips, code_phase_step, rem_code_phase,
              carr_phase_rad, carr_step_rad, carr_rate_rad, n_valid)
