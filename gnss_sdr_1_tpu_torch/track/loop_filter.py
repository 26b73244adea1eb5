"""Tracking loop filters as pure functions on tensors.

Reference parity: src/algorithms/tracking/libs/tracking_loop_filter.{h,cc}
(general 1st-3rd order bilinear-transform IIR, Kaplan & Hegarty Table 5.6)
and tracking_FLL_PLL_filter.cc (FLL-assisted PLL integrator cascade).

Design: coefficients are computed on host per (order, bandwidth, T,
include_last_integrator) and padded to fixed lengths (4 input taps, 3 output
taps) so one batched `iir_apply` covers every order; filter state is a fixed
(inputs[3], outputs[3]) pair carried from epoch to epoch.  The coefficient
functions stay numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class IirState(NamedTuple):
    """Newest-first history of the bilinear IIR (3 = max history needed)."""

    inputs: torch.Tensor    # [..., 3]
    outputs: torch.Tensor   # [..., 3]


def iir_coefficients(
    noise_bandwidth_hz: float,
    update_interval_s: float,
    order: int,
    include_last_integrator: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """(input_coeffs[4], output_coeffs[3]) zero-padded, float32.

    Exact constants from Tracking_loop_filter::update_coefficients.
    """
    t = update_interval_s
    bn = noise_bandwidth_hz
    zeta = 1.0 / math.sqrt(2.0)
    b_in = np.zeros(4, dtype=np.float64)
    b_out = np.zeros(3, dtype=np.float64)
    if order == 1:
        wn = bn * 4.0
        g1 = wn
        if include_last_integrator:
            b_in[0] = g1 * t / 2.0
            b_in[1] = g1 * t / 2.0
            b_out[0] = 1.0
        else:
            b_in[0] = g1
    elif order == 2:
        wn = bn * (8.0 * zeta) / (4.0 * zeta * zeta + 1.0)
        g1 = wn * wn
        g2 = wn * 2.0 * zeta
        if include_last_integrator:
            b_in[0] = t / 2.0 * (g1 * t / 2.0 + g2)
            b_in[1] = t * t / 2.0 * g1
            b_in[2] = t / 2.0 * (g1 * t / 2.0 - g2)
            b_out[0] = 2.0
            b_out[1] = -1.0
        else:
            b_in[0] = g1 * t / 2.0 + g2
            b_in[1] = g1 * t / 2.0 - g2
            b_out[0] = 1.0
    elif order == 3:
        wn = bn / 0.7845
        a3 = 1.1
        b3 = 2.4
        g1 = wn**3
        g2 = a3 * wn * wn
        g3 = b3 * wn
        if include_last_integrator:
            b_in[0] = t / 2.0 * (g3 + t / 2.0 * (g2 + t / 2.0 * g1))
            b_in[1] = t / 2.0 * (-g3 + t / 2.0 * (g2 + 3.0 * t / 2.0 * g1))
            b_in[2] = t / 2.0 * (-g3 - t / 2.0 * (g2 - 3.0 * t / 2.0 * g1))
            b_in[3] = t / 2.0 * (g3 - t / 2.0 * (g2 - t / 2.0 * g1))
            b_out[0] = 3.0
            b_out[1] = -3.0
            b_out[2] = 1.0
        else:
            b_in[0] = g3 + t / 2.0 * (g2 + t / 2.0 * g1)
            b_in[1] = g1 * t * t / 2.0 - 2.0 * g3
            b_in[2] = g3 + t / 2.0 * (-g2 + t / 2.0 * g1)
            b_out[0] = 2.0
            b_out[1] = -1.0
    else:
        raise ValueError(f"loop order must be 1..3, got {order}")
    return b_in.astype(np.float32), b_out.astype(np.float32)


def iir_init(batch_shape: tuple[int, ...] = (), device=None) -> IirState:
    return IirState(
        inputs=torch.zeros(batch_shape + (3,), dtype=torch.float32,
                           device=device),
        outputs=torch.zeros(batch_shape + (3,), dtype=torch.float32,
                            device=device),
    )


def iir_apply(state: IirState, u, b_in, b_out):
    """One filter update.  `u` scalar (or batched), `b_in`[...,4],
    `b_out`[...,3] broadcastable against state.  Returns (new_state, y).

    Matches Tracking_loop_filter::apply: y = sum(b_out * past_outputs) +
    sum(b_in * [u, past_inputs...]).
    """
    past_in = state.inputs
    past_out = state.outputs
    u = torch.as_tensor(u, dtype=torch.float32, device=past_in.device)
    new_in = torch.cat([u[..., None], past_in[..., :2]], dim=-1)  # [...,3]
    y = (
        torch.sum(b_out * past_out, dim=-1)
        + b_in[..., 0] * u
        + torch.sum(b_in[..., 1:] * past_in, dim=-1)
    )
    new_out = torch.cat([y[..., None], past_out[..., :2]], dim=-1)
    return IirState(inputs=new_in, outputs=new_out), y


def iir_reset(state: IirState, value, mask):
    """Reset masked lanes so the filter output starts from `value`
    (Tracking_loop_filter::initialize semantics: history preset so the next
    output continues from the initial rate, used at pull-in with the
    acquisition Doppler)."""
    mask = mask[..., None]
    value = torch.as_tensor(value, dtype=torch.float32,
                            device=state.inputs.device)[..., None]
    return IirState(
        inputs=torch.where(mask, torch.zeros_like(state.inputs),
                           state.inputs),
        outputs=torch.where(mask, value.expand_as(state.outputs),
                            state.outputs),
    )


class FllPllState(NamedTuple):
    """Integrator states of the FLL-assisted PLL (Kaplan fig. 5.x cascade)."""

    w: torch.Tensor
    x: torch.Tensor


class FllPllCoeffs(NamedTuple):
    order: int
    w0p: float
    w0p2: float
    w0p3: float
    w0f: float
    w0f2: float
    a2: float
    a3: float
    b3: float


def fll_pll_coefficients(fll_bw_hz: float, pll_bw_hz: float, order: int) -> FllPllCoeffs:
    """Constants from Tracking_FLL_PLL_filter::set_params."""
    if order == 3:
        w0p = pll_bw_hz / 0.7845
        w0f = fll_bw_hz / 0.53
        return FllPllCoeffs(3, w0p, w0p * w0p, w0p**3, w0f, w0f * w0f,
                            1.414, 1.100, 2.400)
    w0p = pll_bw_hz / 0.53
    w0f = fll_bw_hz / 0.25
    return FllPllCoeffs(2, w0p, w0p * w0p, 0.0, w0f, 0.0, 1.414, 0.0, 0.0)


def fll_pll_init(c: FllPllCoeffs, acq_doppler_hz, batch_shape=(),
                 device=None) -> FllPllState:
    """Tracking_FLL_PLL_filter::initialize — seed with acquisition Doppler."""
    d = torch.as_tensor(acq_doppler_hz, dtype=torch.float32,
                        device=device).expand(batch_shape).clone()
    if c.order == 3:
        return FllPllState(w=torch.zeros_like(d), x=2.0 * d)
    return FllPllState(w=d, x=torch.zeros_like(d))


def fll_pll_apply(state: FllPllState, c: FllPllCoeffs, fll_disc, pll_disc, t):
    """One update; returns (new_state, carrier_error_hz).
    Exact recursions from Tracking_FLL_PLL_filter::get_carrier_error."""
    if c.order == 3:
        w = state.w + t * (c.w0p3 * pll_disc + c.w0f2 * fll_disc)
        x = state.x + t * (0.5 * w + c.a2 * c.w0f * fll_disc
                           + c.a3 * c.w0p2 * pll_disc)
        err = 0.5 * x + c.b3 * c.w0p * pll_disc
        return FllPllState(w=w, x=x), err
    w = state.w + t * (c.w0p2 * pll_disc + c.w0f * fll_disc)
    err = 0.5 * (w + state.w) + c.a2 * c.w0p * pll_disc
    return FllPllState(w=w, x=state.x), err
