"""CN0 estimation and lock detection (pure torch).

Reference parity: src/algorithms/tracking/libs/lock_detectors.{h,cc}
(lock_detectors.h:75-92); formulas per SURVEY.md A.7.
"""

from __future__ import annotations

import math

import torch

_TINY = float(torch.finfo(torch.float32).tiny)


def cn0_svn_estimator(prompt_buffer, coh_time_s):
    """Signal-to-Noise-Variance C/N0 estimator over a buffer of prompts.

    prompt_buffer: complex[..., N] of consecutive Prompt correlator outputs.
    Ps_hat = (mean|Re P|)^2 ; Ptot_hat = mean|P|^2 ;
    rho = Ps/(Ptot - Ps) ; CN0_dBHz = 10log10(rho) - 10log10(T_int).
    Ref: cn0_svn_estimator (lock_detectors.cc:69-90).
    """
    psig = torch.mean(torch.abs(prompt_buffer.real), dim=-1) ** 2
    ptot = torch.mean(prompt_buffer.real ** 2 + prompt_buffer.imag ** 2,
                      dim=-1)
    noise = torch.clamp(ptot - psig, min=_TINY)
    rho = psig / noise
    return (10.0 * torch.log10(torch.clamp(rho, min=1e-10))
            - 10.0 * math.log10(coh_time_s))


def carrier_lock_detector(prompt_buffer):
    """Carrier phase lock metric: cos(2*phi) estimate over the prompt buffer.

    cos(2phi) = (sum I^2 - sum Q^2) / (sum I^2 + sum Q^2); compare against
    `carrier_lock_th` (default 0.85).  Ref: carrier_lock_detector
    (lock_detectors.cc:92-113).
    """
    i2 = torch.sum(prompt_buffer.real ** 2, dim=-1)
    q2 = torch.sum(prompt_buffer.imag ** 2, dim=-1)
    tot = torch.clamp(i2 + q2, min=_TINY)
    return (i2 - q2) / tot
