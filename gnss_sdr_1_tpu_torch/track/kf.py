"""Kalman-filter carrier tracking (channel-batched, torch).

Reference parity: gps_l1_ca_kf_tracking_cc.{h,cc} (src/algorithms/tracking/
gnuradio_blocks/, state model :203-249, predict/update :748-796) and the
normal-inverse-Wishart measurement-covariance estimator
(src/algorithms/tracking/libs/bayesian_estimation.cc:update_sequential).

The filter state is batched over channels ([C, 3] state, [C, 3, 3]
covariance) and every epoch's predict + scalar-measurement update is
closed-form (the innovation covariance is 1x1, so no matrix inverse).
The epochs of a block are serial: each epoch's correlation reads the code
and carrier phase the previous epoch's update left.  The JAX package runs
a block as one `lax.scan` program; here a block, or a capture segment of
consecutive blocks, is one launch of the hand-written kernel
ops.kf_block (csrc/kf_block.cu) on the card, and its plain torch walk on
the CPU.  The engine packs the state into the kernel's rows once per call
and unpacks it after.

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

The receiver builds the engine for every signal it carries; BOC signals
(Galileo E1B) run in the virtual half-chip basis (the sinBOC replica at 1
sample per half-chip, the code length and rate doubled).  The code tables
are +-1 (checked for the card, where the kernel keeps them as bits).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import kf_block as kb
from ..ops.kf_block import KfSpec, _phase_sigma2
from ..ops.track_chain import _f32
from .loop_filter import IirState, iir_coefficients

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
    for.  The constants of the epoch step (`_F`, `_Q`, `_shifts`, the DLL
    coefficients) stay on the host: they reach the block walk as floats of
    its KfSpec."""

    def __init__(self, cfg: KfTrackConfig, codes: np.ndarray, device=None):
        if cfg.order not in (2, 3):
            raise ValueError("KF order must be 2 or 3")
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        codes = np.asarray(codes, np.float32)
        if dev.type == "cuda" and not np.all(np.abs(codes) == 1.0):
            raise ValueError("the KF kernel takes +-1 code tables")
        self._codes = torch.as_tensor(codes, device=dev)
        el = cfg.early_late_space_chips
        self._shifts = np.asarray([-el, 0.0, el], np.float32)
        self._dll_b_in, self._dll_b_out = iir_coefficients(
            cfg.dll_bw_hz, cfg.code_period_s, 2, False)
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
        self._F = torch.as_tensor(f)
        self._Q = torch.as_tensor(q)
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
        self._specs: dict[tuple[int, int], KfSpec] = {}

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

    # ---------------- the block walk ----------------

    def block_spec(self, base: int, n_blocks: int = 1) -> KfSpec:
        """The static configuration of a walk over `n_blocks` blocks of
        `base` samples (each base // (t0_int - 2) + 2 epochs), made once
        per (base, n_blocks)."""
        key = (int(base), int(n_blocks))
        if key not in self._specs:
            self._specs[key] = self._make_spec(*key)
        return self._specs[key]

    def _make_spec(self, base: int, n_blocks: int) -> KfSpec:
        cfg, c = self.cfg, self._c
        return KfSpec(
            C=cfg.n_channels, n_hist=cfg.cn0_samples,
            code_len=int(self._codes.shape[1]), n_max=cfg.epoch_samples_max,
            win=self._win, base=base,
            n_epochs=base // (self._t0_int - 2) + 2,
            n_blocks=n_blocks, order=cfg.order,
            bayes_run=bool(cfg.bayes_run), bayes_ptrans=cfg.bayes_ptrans,
            bayes_strans=cfg.bayes_strans, max_lock_fail=cfg.max_lock_fail,
            t0_int=self._t0_int, chip_rate=c["chip_rate"], fs=c["fs"],
            two_pi=c["two_pi"], fs2=c["fs2"], t=c["t"], aid=c["aid"],
            t0_int_f=c["t0_int"], t0_frac=c["t0_frac"],
            cn0_min_dbhz=_f32(cfg.cn0_min_dbhz),
            carrier_lock_th=_f32(cfg.carrier_lock_th),
            shifts=tuple(_f32(v) for v in self._shifts),
            F=tuple(float(v) for v in self._F.numpy().ravel()),
            Q=tuple(float(v) for v in self._Q.numpy().ravel()),
            dll_b_in=tuple(float(v) for v in self._dll_b_in),
            dll_b_out=tuple(float(v) for v in self._dll_b_out))

    def pack_state(self, state: KfTrackState):
        """The state as the kernel's rows: (fst [SF, C] f32, ist [SI, C]
        i32), ops.kf_block's R_* / I_* layout."""
        C = self.cfg.n_channels
        fr = [state.rem_code_phase_samples[None], state.code_freq_delta[None],
              state.x.T, state.P.reshape(C, 9).T,
              state.code_filter.inputs.T, state.code_filter.outputs.T,
              state.cn0_dbhz[None], state.niw_mu[None],
              state.niw_kappa[None], state.niw_nu[None], state.niw_psi[None],
              state.niw_psi_est[None], state.prompt_hist.real.T,
              state.prompt_hist.imag.T]
        fst = torch.cat(fr)
        ist = torch.stack([state.active.to(_I32), state.prn_slot,
                           state.start, state.cur_len, state.hist_count,
                           state.lock_fail, state.epochs]).to(_I32)
        return fst, ist

    def unpack_state(self, fst, ist) -> KfTrackState:
        """Inverse of pack_state (views of the rows where it can)."""
        C, N = self.cfg.n_channels, self.cfg.cn0_samples
        h = kb.R_HIST
        return KfTrackState(
            active=ist[kb.I_ACTIVE] != 0, prn_slot=ist[kb.I_SLOT],
            start=ist[kb.I_START], cur_len=ist[kb.I_CURLEN],
            rem_code_phase_samples=fst[kb.R_REM_CODE],
            code_freq_delta=fst[kb.R_DELTA],
            x=fst[kb.R_X:kb.R_X + 3].T,
            P=fst[kb.R_P:kb.R_P + 9].T.reshape(C, 3, 3),
            code_filter=IirState(
                inputs=fst[kb.R_DLL_IN:kb.R_DLL_IN + 3].T,
                outputs=fst[kb.R_DLL_OUT:kb.R_DLL_OUT + 3].T),
            cn0_dbhz=fst[kb.R_CN0],
            prompt_hist=torch.complex(fst[h:h + N].T, fst[h + N:h + 2 * N].T),
            hist_count=ist[kb.I_HIST_COUNT], lock_fail=ist[kb.I_LOCK_FAIL],
            epochs=ist[kb.I_EPOCHS],
            niw_mu=fst[kb.R_NIW_MU], niw_kappa=fst[kb.R_NIW_KAPPA],
            niw_nu=fst[kb.R_NIW_NU], niw_psi=fst[kb.R_NIW_PSI],
            niw_psi_est=fst[kb.R_NIW_PSI_EST])

    def _samples(self, samples) -> torch.Tensor:
        if isinstance(samples, torch.Tensor):
            if samples.device.type != self.device.type:
                raise ValueError(f"samples lie on {samples.device}, engine "
                                 f"on {self.device}")
            return samples.to(torch.complex64).contiguous()
        return torch.as_tensor(np.array(samples, dtype=np.complex64),
                               device=self.device)

    def track_blocks(self, samples, state: KfTrackState, base: int,
                     n_blocks: int = 1):
        """Track `n_blocks` consecutive blocks of `base` samples in one
        call (complex64, numpy or a tensor, >= n_blocks * base +
        epoch_samples_max samples): every epoch that starts within
        [b * base, (b + 1) * base) of block b.  On the card one kf_block
        launch walks them all; on the CPU the plain walk.  Returns (state
        rebased by n_blocks * base, KfTrackOutputs over n_blocks *
        (base // (t0_int - 2) + 2) epochs with starts relative to
        samples[0], numpy)."""
        spec = self.block_spec(base, n_blocks)
        if samples.shape[0] < n_blocks * base + self.cfg.epoch_samples_max:
            raise ValueError("samples must hold n_blocks * base + "
                             "epoch_samples_max samples")
        fst, ist = self.pack_state(state)
        out_f, out_i, fst, ist = kb.kf_block(spec, self._samples(samples),
                                             self._codes, fst, ist)
        of, oi = out_f.cpu().numpy(), out_i.cpu().numpy()
        start = oi[:, kb.OI_START] + (np.arange(len(oi)) // spec.n_epochs
                                      * spec.base)[:, None].astype(np.int32)
        corr = of[:, kb.O_CORR:kb.O_CORR + 3] \
            + 1j * of[:, kb.O_CORR + 3:kb.O_CORR + 6]
        outs = KfTrackOutputs(
            valid=oi[:, kb.OI_VALID] != 0, start=start,
            cur_len=oi[:, kb.OI_CURLEN],
            correlators=corr.transpose(0, 2, 1).astype(np.complex64),
            carrier_doppler_hz=of[:, kb.O_DOPPLER],
            doppler_rate_hz_s=of[:, kb.O_DOPPLER_RATE],
            carr_phase_sigma2=of[:, kb.O_SIGMA2],
            code_freq_delta=of[:, kb.O_DELTA],
            rem_code_phase_samples=of[:, kb.O_REM_CODE],
            rem_carr_phase_rad=of[:, kb.O_REM_CARR],
            cn0_dbhz=of[:, kb.O_CN0],
            active=oi[:, kb.OI_ACTIVE] != 0)
        return self.unpack_state(fst, ist), outs

    def track_block(self, samples, state: KfTrackState, base: int):
        """Track every epoch that starts within [0, base) of `samples`
        (>= base + epoch_samples_max samples).  Returns (state rebased by
        base, KfTrackOutputs over base // (t0_int - 2) + 2 epochs,
        numpy)."""
        return self.track_blocks(samples, state, base, 1)
