"""Gather multicorrelator: carrier wipe-off + code resampling + K-tap dot
products, in plain torch ops (any device).

Reference parity: volk_gnsssdr_32fc_32f_rotator_dot_prod_32fc_xn.h
(rotator + multi-dot product, SURVEY.md A.1) fused with
volk_gnsssdr_32f_xn_resampler_32f_xn.h (floor code resampler, A.2), as
driven by cpu_multicorrelator_real_codes.cc:129-169.  The JAX package
computes it in XLA (no Pallas kernel).  `multicorrelate` is the plain
version (the KF and gather walks call it per epoch); `multicorrelate_cuda`
runs one epoch of C channels as one hand kernel (csrc/multicorrelate.cuh),
and `correlate` picks between them by the device of the samples (the TCP
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
    wiped = samples * torch.complex(torch.cos(phase), -torch.sin(phase))
    if n_valid is not None:
        wiped = torch.where(n < _as_f32(n_valid, dev)[..., None], wiped,
                            torch.zeros((), dtype=wiped.dtype, device=dev))
    shifts = _as_f32(shifts_chips, dev)
    idx = _code_indices(n, _as_f32(code_phase_step, dev), shifts,
                        _as_f32(rem_code_phase, dev), code.shape[-1])
    lead = idx.shape[:-2]
    codes = torch.gather(code.expand(lead + code.shape[-1:])[..., None, :]
                         .expand(idx.shape[:-1] + code.shape[-1:]), -1, idx)
    re = (codes @ wiped.real[..., None])[..., 0]
    im = (codes @ wiped.imag[..., None])[..., 0]
    return torch.complex(re, im)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/multicorrelate.cuh): one epoch, C channels, one thread
# block each
# ---------------------------------------------------------------------------

MC_MAX_K = 5

# kernel launches made by `multicorrelate_cuda` (never by multicorrelate)
launches = 0


class McParams(ctypes.Structure):
    """Mirror of `McParams` in csrc/multicorrelate.cuh."""

    _fields_ = [("C", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("L", ctypes.c_int), ("order", ctypes.c_int),
                ("shifts", ctypes.c_float * MC_MAX_K)]


def multicorrelate_cuda(samples, code, shifts_chips, code_phase_step,
                        rem_code_phase, carr_phase_rad, carr_step_rad,
                        carr_rate_rad=0.0, n_valid=None):
    """`multicorrelate` as one kernel launch for CUDA tensors: `samples`
    [C, N] (or [N]) complex64 and `code` [C, L] (or [L]) +-1 float32 on the
    card, K = 3 or 5 taps, the per-channel arguments scalars or [C].
    Returns complex64 [C, K] (or [K])."""
    global launches
    from ._build import gather_library

    one = samples.dim() == 1
    x = samples[None] if one else samples
    codes = code[None] if code.dim() == 1 else code
    C, N = x.shape
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("multicorrelate_cuda takes CUDA tensors")
    if x.dtype != torch.complex64 or codes.dtype != _F32:
        raise ValueError("samples must be complex64 and code float32")
    shifts = [float(v) for v in torch.as_tensor(shifts_chips).reshape(-1)]
    K = len(shifts)
    if K not in (3, 5) or codes.shape[0] != C:
        raise ValueError(f"the kernel takes K=3 or 5 taps and a code row per "
                         f"channel, got K={K}, codes {tuple(codes.shape)}")

    def per_ch(v, dtype=_F32):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(
            C).contiguous()

    cr = per_ch(carr_rate_rad)
    p = McParams(C=C, K=K, N=N, L=codes.shape[1],
                 order=3 if bool((cr != 0).any()) else 2)
    for k, v in enumerate(shifts):
        p.shifts[k] = float(np.float32(v))
    nv = per_ch(N if n_valid is None else n_valid, torch.int32)
    args = [x.contiguous(), codes.contiguous(), per_ch(code_phase_step),
            per_ch(rem_code_phase), per_ch(carr_phase_rad),
            per_ch(carr_step_rad), cr, nv]
    out = torch.empty((C, K), dtype=torch.complex64, device=dev)
    err = gather_library().multicorrelate_launch(
        *(t.data_ptr() for t in args), out.data_ptr(), ctypes.addressof(p),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"multicorrelate kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out[0] if one else out


def correlate(samples, code, shifts_chips, code_phase_step, rem_code_phase,
              carr_phase_rad, carr_step_rad, carr_rate_rad=0.0,
              n_valid=None):
    """The multicorrelator where `samples` lies: the CUDA kernel on the
    card, the plain `multicorrelate` on the CPU."""
    fn = multicorrelate_cuda if samples.device.type == "cuda" \
        else multicorrelate
    return fn(samples, code, shifts_chips, code_phase_step, rem_code_phase,
              carr_phase_rad, carr_step_rad, carr_rate_rad, n_valid)
