"""Tracking discriminators (pure torch functions on complex tensors).

Reference parity: src/algorithms/tracking/libs/tracking_discriminators.{h,cc}
(tracking_discriminators.h:53-100).  Exact formulas per SURVEY.md A.3; all
angles in radians, outputs normalized as in the reference (the /2pi to Hz
conversion happens in the caller, as in dll_pll_veml_tracking.cc:921-928).
"""

from __future__ import annotations

import torch


def pll_cloop_two_quadrant_atan(prompt):
    """Costas-loop two-quadrant arctan: atan(Q/I), 0 when I == 0.
    Ref: pll_cloop_two_quadrant_atan (tracking_discriminators.cc)."""
    i = prompt.real
    q = prompt.imag
    return torch.where(i != 0.0, torch.atan2(q * torch.sign(i), torch.abs(i)),
                       torch.zeros_like(i))


def pll_four_quadrant_atan(prompt):
    """Four-quadrant arctan atan2(Q, I) — used once the secondary code /
    pilot is locked (data-free channel)."""
    return torch.atan2(prompt.imag, prompt.real)


def fll_four_quadrant_atan(p1, p2, t1, t2):
    """FLL cross/dot discriminator over consecutive prompts:
    atan2(cross, dot) / (t2 - t1) [rad/s].
    dot = I1*I2 + Q1*Q2, cross = I1*Q2 - I2*Q1."""
    dot = p1.real * p2.real + p1.imag * p2.imag
    cross = p1.real * p2.imag - p2.real * p1.imag
    return torch.atan2(cross, dot) / (t2 - t1)


def dll_nc_e_minus_l_normalized(early, late):
    """Normalized non-coherent Early-minus-Late envelope:
    0.5 * (|E| - |L|) / (|E| + |L|)  (magnitudes, not powers)."""
    e = torch.abs(early)
    l = torch.abs(late)
    s = e + l
    return torch.where(s > 0.0, 0.5 * (e - l) / s, torch.zeros_like(s))


def dll_nc_vemlp_normalized(very_early, early, late, very_late):
    """VEML power discriminator:
    (sqrt(|VE|^2+|E|^2) - sqrt(|VL|^2+|L|^2)) / (sum of both)."""
    p_early = torch.sqrt(torch.abs(very_early) ** 2 + torch.abs(early) ** 2)
    p_late = torch.sqrt(torch.abs(very_late) ** 2 + torch.abs(late) ** 2)
    s = p_early + p_late
    return torch.where(s > 0.0, (p_early - p_late) / s, torch.zeros_like(s))
