"""Sequential RTK EKF: time-recursive double-difference relative
positioning with per-epoch MLAMBDA ambiguity resolution.

Reference parity: rtklib_rtkpos.cc relpos() (:2199) — the reference's
RTK engine is an extended Kalman filter over rover position(/velocity)
and carrier ambiguities, updated each epoch with code+carrier double
differences against a base station, then resolved to integers with
LAMBDA and validated by the ratio test (resamb_LAMBDA).  pvt.rtk's batch
solver covers the static window case; this module is the time-recursive
processor the reference runs for kinematic rovers:

  state   x = [rover ECEF (3) | (velocity (3), kinematic) | DD float
               ambiguities per tracked satellite (cycles)]
  predict pos/vel random walk (static: tiny process noise; kinematic:
          velocity-driven with accel noise, rtklib udpos)
  update  DD pseudorange + DD carrier phase vs the highest-elevation
          reference satellite, elevation-weighted R (rtklib ddres)
  resolve MLAMBDA on the ambiguity block each epoch; on ratio-test
          acceptance the fixed position is the float state conditioned on
          the integer ambiguities (rtklib resamb_LAMBDA/holdamb without
          the hold)

Ambiguity bookkeeping mirrors rtklib udbias: new satellites initialize
from (DD phase - DD code / lambda) with a large variance; satellites that
disappear drop their state; a reference-satellite switch remaps the DD
ambiguities (N_i' = N_i - N_newref).  All host-side float64 (PVT plane).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .geodesy import az_el
from .rtk import _sat_pos_at, interpolate_base, lambda_ilse


@dataclasses.dataclass
class EkfEpochSolution:
    tow: float
    rover_float_ecef_m: np.ndarray
    rover_fixed_ecef_m: np.ndarray | None
    fixed: bool
    ratio: float
    n_dd: int


class RtkEkf:
    """Single-baseline sequential RTK filter (relpos analogue)."""

    def __init__(self, base_ecef, ephemerides: dict, wavelength_m: float,
                 mode: str = "Kinematic",
                 code_sigma_m: float = 0.7, phase_sigma_m: float = 0.008,
                 accel_sigma_ms2: float = 1.0,
                 static_pos_noise_ms: float = 1e-4,
                 amb_init_sigma_cyc: float = 30.0,
                 ratio_threshold: float = 3.0,
                 el_mask_deg: float = 10.0,
                 innovation_gate_m: float = 30.0):
        self.base = np.asarray(base_ecef, dtype=np.float64)
        self.ephs = dict(ephemerides)
        self.lam = float(wavelength_m)
        self.kinematic = mode.upper().startswith("KIN")
        self.cfg = dict(code_sigma=code_sigma_m, phase_sigma=phase_sigma_m,
                        accel_sigma=accel_sigma_ms2,
                        static_noise=static_pos_noise_ms,
                        amb_sigma=amb_init_sigma_cyc,
                        ratio=ratio_threshold, el_mask=el_mask_deg,
                        gate=innovation_gate_m)
        self.np_ = 6 if self.kinematic else 3      # position(+velocity)
        self.x = None                              # [np_ + n_amb]
        self.P = None
        self.amb_sats: list[int] = []              # DD sat per amb state
        self.ref: int | None = None
        self.last_tow: float | None = None
        self.solutions: list[EkfEpochSolution] = []

    # ---------------- state management (rtklib udstate) ----------------

    def _init_filter(self, x0: np.ndarray) -> None:
        self.x = np.zeros(self.np_)
        self.x[:3] = x0
        self.P = np.zeros((self.np_, self.np_))
        self.P[:3, :3] = np.eye(3) * 100.0 ** 2
        if self.kinematic:
            self.P[3:6, 3:6] = np.eye(3) * 10.0 ** 2
        self.amb_sats = []

    def _predict(self, dt: float) -> None:
        if self.kinematic and dt > 0:
            F = np.eye(len(self.x))
            F[0:3, 3:6] = np.eye(3) * dt
            self.x = F @ self.x
            q = self.cfg["accel_sigma"] ** 2
            Q = np.zeros_like(self.P)
            Q[0:3, 0:3] = np.eye(3) * q * dt ** 3 / 3.0
            Q[0:3, 3:6] = Q[3:6, 0:3] = np.eye(3) * q * dt ** 2 / 2.0
            Q[3:6, 3:6] = np.eye(3) * q * dt
            self.P = F @ self.P @ F.T + Q
        elif dt > 0:
            self.P[:3, :3] += np.eye(3) * (
                self.cfg["static_noise"] * dt) ** 2

    def _drop_amb(self, idx: int) -> None:
        k = self.np_ + idx
        keep = [i for i in range(len(self.x)) if i != k]
        self.x = self.x[keep]
        self.P = self.P[np.ix_(keep, keep)]
        del self.amb_sats[idx]

    def _add_amb(self, sat: int, a0: float) -> None:
        n = len(self.x)
        self.x = np.append(self.x, a0)
        P = np.zeros((n + 1, n + 1))
        P[:n, :n] = self.P
        P[n, n] = self.cfg["amb_sigma"] ** 2
        self.P = P
        self.amb_sats.append(sat)

    def _switch_ref(self, new_ref: int) -> None:
        """Remap DD ambiguities to a new reference satellite:
        N_i|new = N_i|old - N_newref|old (exact linear transform of the
        state, applied to x and P)."""
        if new_ref not in self.amb_sats:
            self.ref = new_ref
            return
        j = self.amb_sats.index(new_ref)
        kj = self.np_ + j
        T = np.eye(len(self.x))
        for i in range(len(self.amb_sats)):
            if i != j:
                T[self.np_ + i, kj] -= 1.0
        # the old reference becomes a DD sat: N_oldref|new = -N_newref|old
        T[kj, kj] = -1.0
        self.x = T @ self.x
        self.P = T @ self.P @ T.T
        self.amb_sats[j] = self.ref
        self.ref = new_ref

    # ---------------- epoch update (relpos) ----------------

    def process_epoch(self, tow: float, rover_obs: dict, base_obs: dict
                      ) -> EkfEpochSolution | None:
        """One epoch: rover_obs {prn: Observation-like}, base_obs
        {prn: (pseudorange_m, carrier_phase_cycles)} (interpolate_base
        output)."""
        common = sorted(set(rover_obs) & set(base_obs) & set(self.ephs))
        if len(common) < 4:
            return None
        spos = {p: _sat_pos_at(self.ephs[p], tow, base_obs[p][0])
                for p in common}
        els = {p: np.degrees(az_el(self.base, spos[p])[1]) for p in common}
        sats = [p for p in common if els[p] >= self.cfg["el_mask"]]
        if len(sats) < 4:
            return None

        if self.x is None:
            self._init_filter(self.base.copy())
        dt = 0.0 if self.last_tow is None else tow - self.last_tow
        self._predict(dt)
        self.last_tow = tow

        # reference satellite: highest elevation (switch remaps states)
        ref = max(sats, key=lambda p: els[p])
        if self.ref is None:
            self.ref = ref
        elif ref != self.ref:
            if self.ref in sats:
                ref = self.ref if els[self.ref] > 15.0 else ref
            if ref != self.ref:
                self._switch_ref(ref)
        ref = self.ref
        if ref not in sats:      # reference lost: re-anchor
            self._switch_ref(max(sats, key=lambda p: els[p]))
            ref = self.ref
        others = [p for p in sats if p != ref]

        # drop vanished ambiguities; add new ones (rtklib udbias)
        lam = self.lam
        for i in reversed(range(len(self.amb_sats))):
            if self.amb_sats[i] not in others:
                self._drop_amb(i)

        def dd(vals):
            return {p: (vals[p] - vals[ref]) for p in others}

        pr_r = {p: rover_obs[p].pseudorange_m for p in sats}
        ph_r = {p: rover_obs[p].carrier_phase_cycles for p in sats}
        pr_b = {p: base_obs[p][0] for p in sats}
        ph_b = {p: base_obs[p][1] for p in sats}
        dd_code = dd({p: pr_r[p] - pr_b[p] for p in sats})
        dd_phase = dd({p: ph_r[p] - ph_b[p] for p in sats})
        for p in others:
            if p not in self.amb_sats:
                self._add_amb(p, dd_phase[p] + dd_code[p] / lam)

        # measurement update: [DD code; DD phase] for each DD sat
        n = len(self.x)
        rows_h, rows_v, rows_r = [], [], []
        x_pos = self.x[:3]
        rho_r = {p: np.linalg.norm(spos[p] - x_pos) for p in sats}
        rho_b = {p: np.linalg.norm(spos[p] - self.base) for p in sats}
        e = {p: (x_pos - spos[p]) / rho_r[p] for p in sats}
        for p in others:
            g = e[p] - e[ref]
            rng_dd = (rho_r[p] - rho_b[p]) - (rho_r[ref] - rho_b[ref])
            k = self.np_ + self.amb_sats.index(p)
            w_el = 1.0 / max(np.sin(np.radians(els[p])), 0.3) ** 2
            h = np.zeros(n)
            h[:3] = g
            rows_h.append(h)
            rows_v.append(dd_code[p] - rng_dd)
            rows_r.append(self.cfg["code_sigma"] ** 2 * 2.0 * w_el)
            # carrier convention: phase = -range/lambda + N (the
            # receiver's integrated-NCO phase), so d(phase)/dx = -g/lam
            h = np.zeros(n)
            h[:3] = -g / lam
            h[k] = 1.0
            rows_h.append(h)
            rows_v.append(dd_phase[p] + rng_dd / lam - self.x[k])
            rows_r.append((self.cfg["phase_sigma"] / lam) ** 2 * 2.0 * w_el)
        H = np.stack(rows_h)
        v = np.asarray(rows_v)
        R = np.diag(rows_r)
        # innovation gate: a phase outlier (cycle slip) re-initializes that
        # satellite's ambiguity instead of polluting the filter
        for j, p in enumerate(others):
            if abs(v[2 * j + 1]) * lam > self.cfg["gate"]:
                k = self.np_ + self.amb_sats.index(p)
                self.x[k] = dd_phase[p] + dd_code[p] / lam
                self.P[k, :] = 0.0
                self.P[:, k] = 0.0
                self.P[k, k] = self.cfg["amb_sigma"] ** 2
                v[2 * j + 1] = (dd_phase[p]
                                + ((rho_r[p] - rho_b[p])
                                   - (rho_r[ref] - rho_b[ref])) / lam
                                - self.x[k])
        S = H @ self.P @ H.T + R
        K = self.P @ H.T @ np.linalg.solve(S, np.eye(len(v)))
        self.x = self.x + K @ v
        self.P = (np.eye(n) - K @ H) @ self.P
        self.P = 0.5 * (self.P + self.P.T)

        # ambiguity resolution (resamb_LAMBDA)
        fixed = False
        ratio = 0.0
        x_fixed = None
        n_amb = len(self.amb_sats)
        if n_amb >= 3:
            a = self.x[self.np_:]
            Qa = self.P[self.np_:, self.np_:]
            Qxa = self.P[:self.np_, self.np_:]
            try:
                cands, score = lambda_ilse(a, Qa, m=2)
                ratio = float(score[1] / max(score[0], 1e-12))
                if ratio >= self.cfg["ratio"]:
                    a_fix = cands[0]
                    # conditional mean: E[x | a=a_fix] = x + Qxa Qa^-1
                    # (a_fix - a_float)
                    dx = Qxa @ np.linalg.solve(Qa, a_fix - a)
                    x_fixed = (self.x[:self.np_] + dx)[:3].copy()
                    fixed = True
            except np.linalg.LinAlgError:
                pass
        sol = EkfEpochSolution(
            tow=tow, rover_float_ecef_m=self.x[:3].copy(),
            rover_fixed_ecef_m=x_fixed, fixed=fixed, ratio=ratio,
            n_dd=n_amb)
        self.solutions.append(sol)
        return sol


def solve_baseline_ekf(rover_epochs: list, base_epochs: list, base_ecef,
                       ephemerides: dict, wavelength_m: float,
                       mode: str = "Kinematic", **kw) -> list[EkfEpochSolution]:
    """Run the sequential filter over matched epochs (the relpos loop:
    base obs interpolated to rover epoch times)."""
    ekf = RtkEkf(base_ecef, ephemerides, wavelength_m, mode=mode, **kw)
    for tow, robs in rover_epochs:
        bobs = interpolate_base(base_epochs, tow)
        if bobs is not None:
            ekf.process_epoch(tow, robs, bobs)
    return ekf.solutions
