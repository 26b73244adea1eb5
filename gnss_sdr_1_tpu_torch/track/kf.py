"""Kalman-filter carrier tracking (channel-batched, torch).

Reference parity: gps_l1_ca_kf_tracking_cc.{h,cc} (src/algorithms/tracking/
gnuradio_blocks/, state model :203-249, predict/update :748-796) and the
normal-inverse-Wishart measurement-covariance estimator
(src/algorithms/tracking/libs/bayesian_estimation.cc:update_sequential).

The filter state is batched over channels ([C, 3] state, [C, 3, 3]
covariance) and every epoch's predict + scalar-measurement update is
closed-form (the innovation covariance is 1x1, so no matrix inverse).  A
block runs its epochs as a Python loop of torch ops on the engine's device;
each epoch correlates every channel with the gather multicorrelator
(ops.multicorrelator).  The JAX package runs the same epoch step as one
`lax.scan` per block and reaches no Pallas kernel, so no hand kernel
carries it here.

State (order 3; order 2 zeroes the rate row/column):
    x = [carrier phase at epoch start (rad), Doppler (Hz), Doppler rate (Hz/s)]
    F = [[1, 2*pi*T, pi*T^2], [0, 1, T], [0, 0, 1]]        (:214-243)
    H = [1, 0, 0]
    y = Costas two-quadrant atan of the Prompt (rad)       (:752)
    R = sigma2 of the phase detector from the running CN0  (:755-760)
    Q = diag(T^4, T, T)                                    (:210-236)

Code tracking stays the reference's 2nd-order IIR DLL with carrier aiding
(:795-805) — the KF replaces only the PLL/FLL cascade.

Bayesian covariance (bayes_run): after `ptrans` epochs the NIW posterior of
the innovation starts accumulating; after `ptrans + strans` epochs the
innovation covariance P_y is taken from the NIW estimate instead of
H P_pre H' + R (:763-776).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.multicorrelator import multicorrelate
from ..ops.track_chain import _f32, mod_floor
from .discriminators import dll_nc_e_minus_l_normalized, pll_cloop_two_quadrant_atan
from .lock_detectors import carrier_lock_detector, cn0_svn_estimator
from .loop_filter import IirState, iir_apply, iir_coefficients

_TWO_PI = 2.0 * np.pi
_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class KfTrackConfig:
    fs_hz: float
    code_length_chips: int
    chip_rate_chips_s: float
    carrier_freq_hz: float
    n_channels: int = 12
    order: int = 2                     # 2 = phase+Doppler, 3 = +Doppler rate
    dll_bw_hz: float = 2.0
    early_late_space_chips: float = 0.5
    # initial covariances (gps_l1_ca_kf_tracking_cc.cc:195-205)
    sigma2_carrier_phase: float = _TWO_PI / 4.0
    sigma2_doppler: float = 450.0
    sigma2_doppler_rate: float = (4.0 * _TWO_PI) ** 2 / 12.0
    # Bayesian covariance estimation (bce_* ctor args, :254-262)
    bayes_run: bool = False
    bayes_ptrans: int = 50             # prediction-only transitory [epochs]
    bayes_strans: int = 50             # estimation transitory [epochs]
    bayes_nu: int = 0
    bayes_kappa: int = 0
    cn0_samples: int = 20
    cn0_min_dbhz: float = 25.0
    max_lock_fail: int = 50
    carrier_lock_th: float = 0.85

    @property
    def code_period_s(self) -> float:
        return self.code_length_chips / self.chip_rate_chips_s

    @property
    def samples_per_code(self) -> float:
        return self.fs_hz * self.code_length_chips / self.chip_rate_chips_s

    @property
    def epoch_samples_max(self) -> int:
        return int(math.floor(self.samples_per_code * (1.0 + 1e-4))) + 2


class KfTrackState(NamedTuple):
    """Per-channel KF tracking state ([C] leading axis everywhere)."""

    active: torch.Tensor       # bool
    prn_slot: torch.Tensor     # int32
    start: torch.Tensor        # int32 next epoch start (block-relative)
    cur_len: torch.Tensor      # int32
    rem_code_phase_samples: torch.Tensor  # f32
    code_freq_delta: torch.Tensor         # f32 chips/s above nominal
    x: torch.Tensor            # f32 [C, 3] KF state
    P: torch.Tensor            # f32 [C, 3, 3] state covariance
    code_filter: IirState      # DLL IIR
    cn0_dbhz: torch.Tensor     # f32 running CN0 (drives R)
    prompt_hist: torch.Tensor  # complex64 [C, cn0_samples]
    hist_count: torch.Tensor   # int32
    lock_fail: torch.Tensor    # int32
    epochs: torch.Tensor       # int32 KF iterations since pull-in (kf_iter)
    # NIW posterior hyper-parameters of the innovation (scalar case)
    niw_mu: torch.Tensor       # f32
    niw_kappa: torch.Tensor    # f32
    niw_nu: torch.Tensor       # f32
    niw_psi: torch.Tensor      # f32
    niw_psi_est: torch.Tensor  # f32 current Psi estimate (P_y when active)


class KfTrackOutputs(NamedTuple):
    """Per-epoch block outputs (numpy, [n_epochs, C, ...])."""

    valid: np.ndarray
    start: np.ndarray
    cur_len: np.ndarray
    correlators: np.ndarray    # complex64 [E, C, 3]
    carrier_doppler_hz: np.ndarray
    doppler_rate_hz_s: np.ndarray
    carr_phase_sigma2: np.ndarray    # R estimate in use (:791)
    code_freq_delta: np.ndarray
    rem_code_phase_samples: np.ndarray
    # filtered NCO carrier phase (kf_x(0), d_rem_carr_phase_rad :786)
    # wrapped to [0, 2pi) — the receiver's phase ledger consumes it like
    # the DLL/PLL engine's rem_carr_phase_rad output
    rem_carr_phase_rad: np.ndarray
    cn0_dbhz: np.ndarray
    active: np.ndarray


def _phase_sigma2(cn0_dbhz, t):
    """Phase-detector variance from CN0 (gps_l1_ca_kf_tracking_cc.cc:755-758):
    sigma2 = 1/(2*CN0*T) * (1 + 1/(2*CN0*T))   [rad^2]."""
    cn_lin = torch.pow(10.0, cn0_dbhz / 10.0)
    a = 1.0 / (2.0 * cn_lin * t)
    return a * (1.0 + a)


def _set(t: torch.Tensor, ch: int, value) -> torch.Tensor:
    """Functional per-channel update (states are never mutated in place)."""
    t = t.clone()
    t[ch] = value
    return t


# JAX KfTrackState leaf layout: planar float32 [..., 2] prompt history and
# an (inputs, outputs) pair for `code_filter`
def kf_state_from_numpy(arrays: dict, device) -> KfTrackState:
    """Build a KfTrackState from numpy arrays laid out as the JAX package's
    KfTrackState leaves (`prompt_hist` planar [C, N, 2] float32,
    `code_filter` an (inputs [C, 3], outputs [C, 3]) pair)."""
    dev = torch.device(device)
    a = dict(arrays)
    ins, outs = a.pop("code_filter")
    ph = np.asarray(a.pop("prompt_hist"))
    a["prompt_hist"] = (ph[..., 0].astype(np.float32)
                        + 1j * ph[..., 1].astype(np.float32)).astype(
                            np.complex64)

    def conv(v):
        v = np.array(v)                 # own, writable copy
        if v.dtype == np.bool_:
            return torch.as_tensor(v, device=dev)
        if np.issubdtype(v.dtype, np.integer):
            return torch.as_tensor(v.astype(np.int32), device=dev)
        if np.iscomplexobj(v):
            return torch.as_tensor(v.astype(np.complex64), device=dev)
        return torch.as_tensor(v.astype(np.float32), device=dev)

    fields = {k: conv(v) for k, v in a.items()}
    fields["code_filter"] = IirState(inputs=conv(ins), outputs=conv(outs))
    return KfTrackState(**{f: fields[f] for f in KfTrackState._fields})


def kf_state_to_numpy(state: KfTrackState) -> dict:
    """Inverse of kf_state_from_numpy: the JAX KfTrackState leaf layout."""
    out = {}
    for name, t in state._asdict().items():
        if name == "code_filter":
            out[name] = (t.inputs.detach().cpu().numpy(),
                         t.outputs.detach().cpu().numpy())
            continue
        v = t.detach().cpu().numpy()
        if name == "prompt_hist":
            v = np.stack([v.real, v.imag], axis=-1).astype(np.float32)
        out[name] = v
    return out


class KfTrackingEngine:
    """Channel-batched Kalman carrier tracking + IIR DLL.

    `codes` is [n_slots, code_len] float32 +-1 at 1 sample/chip (the gather
    multicorrelator resamples on the fly, A.2 floor contract).  `device`:
    None runs on the card (and raises without one); the CPU only when asked
    for."""

    def __init__(self, cfg: KfTrackConfig, codes: np.ndarray, device=None):
        if cfg.order not in (2, 3):
            raise ValueError("KF order must be 2 or 3")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self._codes = torch.as_tensor(np.asarray(codes, np.float32),
                                      device=dev)
        el = cfg.early_late_space_chips
        self._shifts = torch.tensor([-el, 0.0, el], dtype=_F32, device=dev)
        b_in, b_out = iir_coefficients(cfg.dll_bw_hz, cfg.code_period_s, 2,
                                       False)
        self._dll_b_in = torch.as_tensor(b_in, device=dev)
        self._dll_b_out = torch.as_tensor(b_out, device=dev)
        t0 = float(cfg.samples_per_code)
        self._t0_int = int(np.floor(t0))
        self._t0_frac = float(t0 - self._t0_int)
        self._win = cfg.epoch_samples_max + self._t0_int + 66
        # constant matrices (order 2 zeroes the rate row/col so one [3,3]
        # program covers both orders)
        t = cfg.code_period_s
        f = np.eye(3, dtype=np.float32)
        f[0, 1] = _TWO_PI * t
        f[1, 2] = t
        f[0, 2] = 0.5 * _TWO_PI * t * t
        q = np.diag([t**4, t, t]).astype(np.float32)
        p0 = np.diag([cfg.sigma2_carrier_phase, cfg.sigma2_doppler,
                      cfg.sigma2_doppler_rate]).astype(np.float32)
        if cfg.order == 2:
            f[0, 2] = f[1, 2] = 0.0
            q[2, 2] = 0.0
            p0[2, 2] = 0.0
        self._F = torch.as_tensor(f, device=dev)
        self._Q = torch.as_tensor(q, device=dev)
        self._P0 = p0
        # scalar constants of the epoch step, rounded to float32 as the
        # reference rounds them
        self._c = dict(
            chip_rate=_f32(cfg.chip_rate_chips_s), fs=_f32(cfg.fs_hz),
            two_pi=_f32(_TWO_PI),
            fs2=_f32(_f32(cfg.fs_hz) * _f32(cfg.fs_hz)),
            t=_f32(cfg.code_period_s),
            aid=_f32(_f32(cfg.chip_rate_chips_s)
                     / _f32(cfg.carrier_freq_hz)),
            t0_int=_f32(self._t0_int), t0_frac=_f32(self._t0_frac))

    # ---------------- host state management ----------------

    def init_state(self) -> KfTrackState:
        C, dev = self.cfg.n_channels, self.device
        zf = torch.zeros(C, dtype=_F32, device=dev)
        zi = torch.zeros(C, dtype=_I32, device=dev)
        return KfTrackState(
            active=torch.zeros(C, dtype=torch.bool, device=dev),
            prn_slot=zi, start=zi,
            cur_len=torch.full((C,), self._t0_int, dtype=_I32, device=dev),
            rem_code_phase_samples=zf, code_freq_delta=zf,
            x=torch.zeros((C, 3), dtype=_F32, device=dev),
            P=torch.as_tensor(self._P0, device=dev).expand(C, 3, 3).clone(),
            code_filter=IirState(
                inputs=torch.zeros((C, 3), dtype=_F32, device=dev),
                outputs=torch.zeros((C, 3), dtype=_F32, device=dev)),
            cn0_dbhz=torch.full((C,), 30.0, dtype=_F32, device=dev),
            prompt_hist=torch.zeros((C, self.cfg.cn0_samples),
                                    dtype=torch.complex64, device=dev),
            hist_count=zi, lock_fail=zi, epochs=zi,
            niw_mu=zf, niw_kappa=zf, niw_nu=zf, niw_psi=zf,
            niw_psi_est=zf,
        )

    def activate_channel(self, state: KfTrackState, ch: int, prn_slot: int,
                         acq_delay_samples: float, acq_doppler_hz: float,
                         acq_samplestamp: int, block_start_abs: int,
                         doppler_step_hz: float | None = None) -> KfTrackState:
        """Pull-in (:700-730): align to the acq code boundary, seed the KF
        state from Acq_doppler and the phase implied by the sample offset;
        optionally tighten the Doppler prior to (step/3)^2 (:276-279)."""
        cfg = self.cfg
        code_freq = (1.0 + acq_doppler_hz / cfg.carrier_freq_hz) * cfg.chip_rate_chips_s
        t_prn = cfg.fs_hz * cfg.code_length_chips / code_freq
        boundary_abs = float(acq_samplestamp) + float(acq_delay_samples)
        k = max(0.0, np.ceil((block_start_abs - boundary_abs) / t_prn))
        start_abs = boundary_abs + k * t_prn
        start_rel = start_abs - block_start_abs
        start_i = int(np.floor(start_rel))
        rem = float(start_rel - start_i)
        cur_len = int(np.floor(t_prn + rem))
        samples_offset = start_abs - boundary_abs
        phase0 = _TWO_PI * acq_doppler_hz / cfg.fs_hz * samples_offset  # (:720)

        p0 = np.array(self._P0)
        if doppler_step_hz is not None:
            p0[1, 1] = (float(doppler_step_hz) / 3.0) ** 2
        # Psi prior = (H P0 H' + R)*(nu+2) (:262), R at the initial 30 dB-Hz
        r0 = float(_phase_sigma2(torch.tensor(30.0, dtype=_F32),
                                 cfg.code_period_s))
        s = state
        return s._replace(
            active=_set(s.active, ch, True),
            prn_slot=_set(s.prn_slot, ch, prn_slot),
            start=_set(s.start, ch, start_i),
            cur_len=_set(s.cur_len, ch, cur_len),
            rem_code_phase_samples=_set(s.rem_code_phase_samples, ch, rem),
            code_freq_delta=_set(s.code_freq_delta, ch,
                                 code_freq - cfg.chip_rate_chips_s),
            x=_set(s.x, ch, torch.tensor(
                np.asarray([phase0, acq_doppler_hz, 0.0], np.float32))),
            P=_set(s.P, ch, torch.as_tensor(p0)),
            code_filter=IirState(
                inputs=_set(s.code_filter.inputs, ch, 0.0),
                outputs=_set(s.code_filter.outputs, ch, 0.0)),
            cn0_dbhz=_set(s.cn0_dbhz, ch, 30.0),
            prompt_hist=_set(s.prompt_hist, ch, 0.0),
            hist_count=_set(s.hist_count, ch, 0),
            lock_fail=_set(s.lock_fail, ch, 0),
            epochs=_set(s.epochs, ch, 0),
            niw_mu=_set(s.niw_mu, ch, 0.0),
            niw_kappa=_set(s.niw_kappa, ch, float(cfg.bayes_kappa)),
            niw_nu=_set(s.niw_nu, ch, float(cfg.bayes_nu)),
            niw_psi=_set(s.niw_psi, ch, float(np.float32(
                (p0[0, 0] + r0) * (cfg.bayes_nu + 2.0)))),
            niw_psi_est=_set(s.niw_psi_est, ch, 0.0),
        )

    def rebase(self, state: KfTrackState, base: int) -> KfTrackState:
        return state._replace(start=state.start - int(base))

    def deactivate_channel(self, state: KfTrackState, ch: int) -> KfTrackState:
        return state._replace(active=_set(state.active, ch, False))

    # ---------------- device epoch step ----------------

    def _epoch_step(self, samples, state: KfTrackState, limit: int, n_idx):
        """One epoch of every channel.  `samples` [n_samp] complex64 on the
        engine's device; `n_idx` = arange(epoch_samples_max) (int64)."""
        cfg, c = self.cfg, self._c
        dev = samples.device
        Nmax = cfg.epoch_samples_max
        valid = state.active & (state.start < limit)

        # window origin m and per-channel offsets, clamped as the
        # reference's dynamic_slice clamps
        n_samp = samples.shape[0]
        win = min(self._win, n_samp)
        m = torch.min(torch.where(state.active, state.start,
                                  torch.full_like(state.start, 1 << 29)))
        m = torch.clamp(m, 0, n_samp - win)
        off = torch.clamp(state.start - m, 0, win - Nmax)
        segs = samples[(m + off).to(torch.int64)[:, None] + n_idx]

        code_freq = c["chip_rate"] + state.code_freq_delta
        code_step = code_freq / c["fs"]
        rem_code_chips = code_freq * state.rem_code_phase_samples / c["fs"]
        carr_step = c["two_pi"] * state.x[:, 1] / c["fs"]
        # phase state is the NCO phase at epoch start (d_rem_carr_phase_rad
        # = kf_x(0), :786); order 3 feeds the Doppler-rate state into the
        # correlator's quadratic phase term
        carr_phase = state.x[:, 0]
        carr_rate = (c["two_pi"] * state.x[:, 2] / c["fs2"]
                     if cfg.order == 3 else torch.zeros_like(carr_step))
        corr = multicorrelate(
            segs, self._codes[state.prn_slot.long()], self._shifts,
            code_step, rem_code_chips, carr_phase, carr_step, carr_rate,
            state.cur_len.to(_F32))                      # [C, 3] complex
        prompt = corr[:, 1]

        # --- KF predict (:748-749) ---
        x_pre = state.x @ self._F.T
        P_pre = self._F @ state.P @ self._F.T + self._Q

        # --- measurement (:752-760) ---
        y = pll_cloop_two_quadrant_atan(prompt)          # rad
        r = _phase_sigma2(state.cn0_dbhz, c["t"])

        # --- NIW innovation-covariance estimate (bayesian_estimation.cc,
        # sequential K=1 scalar update) ---
        if cfg.bayes_run:
            upd_niw = valid & (state.epochs >= cfg.bayes_ptrans)
            kap, nu, mu, psi = (state.niw_kappa, state.niw_nu,
                                state.niw_mu, state.niw_psi)
            mu_post = (kap * mu + y) / (kap + 1.0)
            kap_post = kap + 1.0
            nu_post = nu + 1.0
            psi_post = psi + kap / (kap + 1.0) * (y - mu) ** 2
            psi_est = torch.where(nu_post - 2.0 > 0.0,
                                  psi_post / (nu_post - 2.0),
                                  psi_post / (nu_post + 2.0))
            niw_mu = torch.where(upd_niw, mu_post, mu)
            niw_kappa = torch.where(upd_niw, kap_post, kap)
            niw_nu = torch.where(upd_niw, nu_post, nu)
            niw_psi = torch.where(upd_niw, psi_post, psi)
            niw_psi_est = torch.where(upd_niw, psi_est, state.niw_psi_est)
            use_bayes = state.epochs >= (cfg.bayes_ptrans + cfg.bayes_strans)
            p_y = torch.where(use_bayes, niw_psi_est, P_pre[:, 0, 0] + r)
            r_est = torch.where(use_bayes, niw_psi_est - P_pre[:, 0, 0], r)
        else:
            niw_mu, niw_kappa = state.niw_mu, state.niw_kappa
            niw_nu, niw_psi = state.niw_nu, state.niw_psi
            niw_psi_est = state.niw_psi_est
            p_y = P_pre[:, 0, 0] + r
            r_est = r

        # --- scalar-measurement update (:779-782), H = [1,0,0] ---
        K = P_pre[:, :, 0] / p_y[:, None]                # [C, 3]
        x_new = x_pre + K * y[:, None]
        P_new = P_pre - K[:, :, None] * P_pre[:, None, 0, :]

        # --- DLL with carrier aiding (:795-805) ---
        code_err_chips = dll_nc_e_minus_l_normalized(corr[:, 0], corr[:, 2])
        code_filt_new, code_err_filt = iir_apply(
            state.code_filter, code_err_chips, self._dll_b_in,
            self._dll_b_out)
        new_code_freq_delta = c["aid"] * x_new[:, 1] - code_err_filt

        # --- next epoch length (A.6 split precision) ---
        new_code_freq = c["chip_rate"] + new_code_freq_delta
        d_t = -(c["t0_int"] * new_code_freq_delta / new_code_freq
                + c["t0_frac"] * new_code_freq_delta / new_code_freq)
        frac = c["t0_frac"] + d_t + state.rem_code_phase_samples
        frac_floor = torch.floor(frac)
        next_len = self._t0_int + frac_floor.to(_I32)
        new_rem_code = frac - frac_floor

        # --- CN0 / lock supervision (A.7) ---
        N = cfg.cn0_samples
        pushed = torch.cat([state.prompt_hist[:, 1:], prompt[:, None]], dim=1)
        hist = torch.where(valid[:, None], pushed, state.prompt_hist)
        hist_count = torch.clamp(state.hist_count + valid.to(_I32), max=N)
        hist_full = hist_count >= N
        cn0 = cn0_svn_estimator(hist, c["t"])
        cn0_run = torch.where(valid & hist_full, cn0, state.cn0_dbhz)
        carrier_lock = carrier_lock_detector(hist)
        epochs = state.epochs + valid.to(_I32)
        check_now = valid & hist_full & (mod_floor(epochs, N) == 0)
        fail = check_now & ((cn0 < cfg.cn0_min_dbhz)
                            | (carrier_lock < cfg.carrier_lock_th))
        lock_fail = torch.where(
            fail, state.lock_fail + 1,
            torch.where(check_now, torch.clamp(state.lock_fail - 1, min=0),
                        state.lock_fail))
        still_active = state.active & (lock_fail <= cfg.max_lock_fail)

        def mrg(n, o):
            v = valid
            while v.dim() < n.dim():
                v = v[..., None]
            return torch.where(v, n, o)

        new_x = mrg(x_new, state.x)
        new_state = KfTrackState(
            active=mrg(still_active, state.active),
            prn_slot=state.prn_slot,
            start=mrg(state.start + state.cur_len, state.start),
            cur_len=mrg(next_len, state.cur_len),
            rem_code_phase_samples=mrg(new_rem_code,
                                       state.rem_code_phase_samples),
            code_freq_delta=mrg(new_code_freq_delta, state.code_freq_delta),
            x=new_x,
            P=mrg(P_new, state.P),
            code_filter=IirState(
                inputs=mrg(code_filt_new.inputs, state.code_filter.inputs),
                outputs=mrg(code_filt_new.outputs, state.code_filter.outputs)),
            cn0_dbhz=cn0_run,
            prompt_hist=hist,
            hist_count=hist_count,
            lock_fail=mrg(lock_fail, state.lock_fail),
            epochs=epochs,
            niw_mu=niw_mu, niw_kappa=niw_kappa, niw_nu=niw_nu,
            niw_psi=niw_psi, niw_psi_est=niw_psi_est,
        )
        zero = torch.zeros((), dtype=_F32, device=dev)
        outputs = (
            valid, state.start, state.cur_len,
            torch.where(valid[:, None], corr,
                        torch.zeros((), dtype=corr.dtype, device=dev)),
            new_x[:, 1], new_x[:, 2],
            torch.where(valid, r_est, zero),
            new_state.code_freq_delta,
            new_state.rem_code_phase_samples,
            mod_floor(new_x[:, 0], c["two_pi"]),
            torch.where(valid & hist_full, cn0, zero),
            new_state.active,
        )
        return new_state, outputs

    # ---------------- host API ----------------

    def track_block(self, samples, state: KfTrackState, base: int):
        """Track every epoch that starts within [0, base) of `samples`
        (complex64, numpy or a tensor, >= base + epoch_samples_max
        samples).  Returns (state rebased by base, KfTrackOutputs over
        base // (t0_int - 2) + 2 epochs, numpy)."""
        n_epochs = base // (self._t0_int - 2) + 2
        if samples.shape[0] < base + self.cfg.epoch_samples_max:
            raise ValueError("block must hold base + epoch_samples_max samples")
        if isinstance(samples, torch.Tensor):
            if samples.device.type != self.device.type:
                raise ValueError(f"samples lie on {samples.device}, engine "
                                 f"on {self.device}")
            samples = samples.to(torch.complex64)
        else:
            samples = torch.as_tensor(
                np.array(samples, dtype=np.complex64), device=self.device)
        n_idx = torch.arange(self.cfg.epoch_samples_max, device=self.device)
        st, rows = state, []
        for _ in range(n_epochs):
            st, out = self._epoch_step(samples, st, int(base), n_idx)
            rows.append(out)
        outs = KfTrackOutputs(*(torch.stack(col).cpu().numpy()
                                for col in zip(*rows)))
        return self.rebase(st, base), outs
