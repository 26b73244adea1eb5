"""Gather multicorrelator: carrier wipe-off + code resampling + K-tap dot
products, in plain torch ops (any device).

Reference parity: volk_gnsssdr_32fc_32f_rotator_dot_prod_32fc_xn.h
(rotator + multi-dot product, SURVEY.md A.1) fused with
volk_gnsssdr_32f_xn_resampler_32f_xn.h (floor code resampler, A.2), as
driven by cpu_multicorrelator_real_codes.cc:129-169.  The JAX package
computes it in XLA (no Pallas kernel), so plain torch ops are its port.

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

import torch

from .track_chain import mod_floor

_F32 = torch.float32


def _as_f32(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32, device=dev)


def _code_indices(n, code_phase_step, shifts, rem_code_phase, code_len: int):
    """[..., K, N] int64 gather indices into the 1-sample/chip code table."""
    chips = torch.addcmul(shifts[:, None], code_phase_step[..., None, None],
                          n) - rem_code_phase[..., None, None]
    idx = torch.floor(chips).to(torch.int32)
    return mod_floor(idx, code_len).to(torch.int64)


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
