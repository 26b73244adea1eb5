"""Precise Point Positioning (PPP_Static / PPP_Kinematic).

Reference parity: the PPP positioning modes of the reference's PVT block —
rtklib_ppp.cc:1636 pppos() (zenith-tropo + float-ambiguity + per-epoch clock
estimation over undifferenced code+carrier), selected via
PVT.positioning_mode=PPP_Static/PPP_Kinematic (rtklib_solver.cc:491,
pvt_conf).

Architecture difference vs the reference (by design, not translation): the
reference runs a sequential EKF (pppos -> filter()).  Here PPP is a BATCH
weighted Gauss-Newton over an epoch window — the same estimator family as
pvt/rtk.py's baseline processor — with

  * one position (PPP_Static) or a random-walk-regularized position per
    epoch (PPP_Kinematic),
  * one receiver clock per epoch,
  * one zenith wet tropo delay (ZTD) mapped by 1/sin(el), hydrostatic part
    a-priori from Saastamoinen,
  * one float ambiguity per continuous satellite arc (cycle-slip detection
    by jumps in the phase-minus-code combination splits arcs),

over iono-free observables: the dual-frequency IF combination when a second
band is supplied, else the single-frequency GRAPHIC combination (P + L)/2
(first-order iono cancels in both) alongside Klobuchar-corrected code rows
that fix the clock/ambiguity datum.

All math is host-side float64 (PVT plane, SURVEY.md §2.10 TPU mapping).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import SPEED_OF_LIGHT_M_S
from .atmosphere import klobuchar_delay_m
from .ephemeris import satellite_clock_correction, satellite_position_velocity
from .geodesy import az_el, ecef_to_llh
from .solver import _rotate_earth, solve_pvt


@dataclasses.dataclass
class PppConfig:
    mode: str = "PPP_Static"          # or "PPP_Kinematic"
    f1_hz: float = 1575.42e6
    f2_hz: float | None = None        # dual-frequency iono-free when given
    code_sigma_m: float = 0.7
    phase_sigma_m: float = 0.008
    iono: object | None = None        # GpsIono for single-freq code rows
    el_mask_deg: float = 7.0
    # a-priori hydrostatic Saastamoinen (rtklib tropmodel); 'off' for
    # tropo-free synthetic captures, mirroring PVT.trop_model
    trop_model: str = "saastamoinen"
    estimate_ztd: bool = True
    # PPP_Kinematic: epoch-to-epoch position random walk (1-sigma, meters)
    kinematic_process_m: float = 0.5
    # precise products (pvt.precise.Sp3Product): satellites present in the
    # product use its interpolated orbits/clocks instead of broadcast —
    # rtklib satposs' EPHOPT_PREC branch (rtklib_preceph.cc peph2pos)
    precise: object | None = None
    # IONEX TEC grids (pvt.ionex.TecProduct): replaces Klobuchar on the
    # single-frequency code rows (rtklib iontec, IONOOPT_TEC)
    tec: object | None = None
    # solid-earth tides: GPS week enables the antenna displacement model
    # (pvt.tides.tide_displacement; rtklib tidedisp behind opt_tidecorr)
    tides_week: int | None = None
    # cycle-slip detector: jump in (L - P) between consecutive epochs [m]
    slip_threshold_m: float = 3.0
    max_iter: int = 6


@dataclasses.dataclass
class PppObs:
    """One satellite's observables at one epoch.  Phase follows the
    receiver convention (carrier_phase_cycles = -range/lambda + const, see
    observables/__init__.py), i.e. L_m = -lambda * phase_cycles grows with
    range.  Band 2 entries optional."""

    pseudorange_m: float
    carrier_phase_cycles: float
    pseudorange2_m: float | None = None
    carrier_phase2_cycles: float | None = None
    cn0_dbhz: float = 45.0


@dataclasses.dataclass
class PppSolution:
    valid: bool
    mode: str
    rx_ecef_m: np.ndarray | None = None          # static (or last kinematic)
    epoch_positions: list | None = None          # [(tow, xyz)] kinematic
    ztd_wet_m: float = 0.0
    clock_bias_s: np.ndarray | None = None       # per epoch
    ambiguities_m: dict | None = None            # arc -> float N [m]
    n_epochs: int = 0
    n_arcs: int = 0
    sigma0_m: float = 0.0                        # a-posteriori unit sigma


def _sat_state(eph, tow_tag: float, pr_m: float):
    """Satellite ECEF position (earth-rotation corrected) + clock at the
    transmit time implied by the pseudorange.

    `tow_tag` is the epoch tag in RECEIVER-CLOCK time; the conventional
    t_tx = tag - pr/c already removes the receiver clock (the pseudorange
    carries it), so no dts subtraction here (rtklib ephpos/satposs)."""
    from .solver import sat_clock, sat_pos_vel

    tau = pr_m / SPEED_OF_LIGHT_M_S
    t_tx = tow_tag - tau
    clk = sat_clock(eph, t_tx)
    pos, _ = sat_pos_vel(eph, t_tx - clk)
    return _rotate_earth(pos, tau), clk


def _dry_ztd_m(lat_rad: float, height_m: float) -> float:
    """Saastamoinen hydrostatic zenith delay (standard atmosphere), the
    a-priori part of rtklib tropmodel()."""
    h = min(max(height_m, 0.0), 1e4)
    pres = 1013.25 * (1.0 - 2.2557e-5 * h) ** 5.2568
    return float(0.0022768 * pres
                 / (1.0 - 0.00266 * np.cos(2.0 * lat_rad) - 0.00028 * h / 1e3))


def _map_el(el_rad: float) -> float:
    return 1.0 / max(np.sin(el_rad), 0.05)


def _detect_arcs(epochs, lam1: float, lam2: float | None,
                 slip_threshold_m: float):
    """Split each satellite's observation span into continuous arcs on
    cycle slips (rtklib_ppp.cc detslp_gf / detslp_ll).

    Dual-frequency: geometry-free phase L1 - L2 (geometry, clocks and tropo
    cancel; residual is slow iono drift + mm noise), threshold 5 cm —
    catches single-cycle slips.  Single-frequency fallback: jump in the
    phase-minus-code combination, `slip_threshold_m` sized for code noise
    (catches multi-meter slips only, as the reference's detslp_ll does)."""
    arc_of: dict[tuple[int, int], tuple[int, int]] = {}
    last_lp: dict[int, float] = {}
    last_gf: dict[int, float] = {}
    last_seen: dict[int, int] = {}
    arc_idx: dict[int, int] = {}
    for k, (_tow, obs) in enumerate(epochs):
        for prn, o in obs.items():
            lp = -lam1 * o.carrier_phase_cycles - o.pseudorange_m
            gf = None
            if lam2 is not None and o.carrier_phase2_cycles is not None:
                gf = (-lam1 * o.carrier_phase_cycles
                      + lam2 * o.carrier_phase2_cycles)
            if prn not in arc_idx:
                arc_idx[prn] = 0
            elif (k - last_seen[prn] > 25
                  or (gf is not None and prn in last_gf
                      and abs(gf - last_gf[prn]) > 0.05)
                  or abs(lp - last_lp[prn]) > slip_threshold_m):
                arc_idx[prn] += 1
            arc_of[(k, prn)] = (prn, arc_idx[prn])
            last_lp[prn] = lp
            if gf is not None:
                last_gf[prn] = gf
            last_seen[prn] = k
    return arc_of


def solve_ppp(
    epochs: list,
    ephemerides: dict,
    cfg: PppConfig | None = None,
) -> PppSolution:
    """Batch PPP over `epochs` = [(rx_tow_s, {prn: PppObs})].

    PPP_Static estimates one position; PPP_Kinematic one per epoch with a
    random-walk tie.  Returns float-ambiguity (no integer fixing — matching
    the reference, whose PPP modes are float-only: rtklib_ppp.cc pppos).
    """
    cfg = cfg or PppConfig()
    inval = PppSolution(False, cfg.mode)
    if cfg.precise is not None:
        # precise orbits/clocks where available, broadcast fallback per sat
        prec = cfg.precise.as_ephemerides()
        ephemerides = {**ephemerides,
                       **{p: e for p, e in prec.items() if p in ephemerides
                          or not ephemerides}}
    kinematic = cfg.mode.upper().endswith("KINEMATIC")
    lam1 = SPEED_OF_LIGHT_M_S / cfg.f1_hz
    dual = cfg.f2_hz is not None
    if dual:
        g1 = cfg.f1_hz ** 2 / (cfg.f1_hz ** 2 - cfg.f2_hz ** 2)
        g2 = cfg.f2_hz ** 2 / (cfg.f1_hz ** 2 - cfg.f2_hz ** 2)
        lam2 = SPEED_OF_LIGHT_M_S / cfg.f2_hz

    # usable epochs: >= 4 sats with ephemerides
    use = []
    for tow, obs in epochs:
        sats = sorted(p for p in obs if p in ephemerides)
        if dual:
            sats = [p for p in sats if obs[p].pseudorange2_m is not None]
        if len(sats) >= 4:
            use.append((tow, {p: obs[p] for p in sats}))
    K = len(use)
    if K < (2 if kinematic else 1):
        return inval

    # ZTD needs satellite-geometry change to separate from clock + height:
    # below ~2 minutes of data the column is numerically degenerate and the
    # solution wanders tens of meters — fall back to the a-priori-only
    # tropo (the reference's EKF handles this with a process-noise prior,
    # rtklib_ppp.cc udtrop_ppp)
    span_s = use[-1][0] - use[0][0]
    estimate_ztd = cfg.estimate_ztd and span_s >= 120.0

    arc_of = _detect_arcs(use, lam1, lam2 if dual else None,
                          cfg.slip_threshold_m)
    arcs = sorted(set(arc_of.values()))
    S = len(arcs)
    arc_col = {a: i for i, a in enumerate(arcs)}

    # initial position: single-point LS on the first epoch
    t0, o0 = use[0]
    sp0 = solve_pvt(ephemerides, {p: o.pseudorange_m for p, o in o0.items()},
                    t0)
    if not sp0.valid:
        return inval

    n_pos = 3 * K if kinematic else 3
    n_unk = n_pos + K + (1 if estimate_ztd else 0) + S
    ztd_col = n_pos + K
    amb0 = n_pos + K + (1 if estimate_ztd else 0)

    x_pos = np.tile(sp0.rx_ecef_m, (K, 1)) if kinematic \
        else sp0.rx_ecef_m.copy()
    dts = np.zeros(K)
    ztd_w = 0.1
    amb = np.zeros(S)

    w_code = 1.0 / cfg.code_sigma_m
    w_phase = 1.0 / cfg.phase_sigma_m
    # single-frequency without broadcast iono parameters: the raw-code rows
    # carry an unmodeled iono slant delay — inflate their sigma moderately
    # (rtklib varerr() ERR_BRDCI term).  They must stay strong enough to
    # anchor the clock/ambiguity datum (GRAPHIC rows alone are near-singular
    # in position over short windows).
    w_code_raw = w_code
    if not dual and cfg.iono is None:
        w_code_raw = 1.0 / np.hypot(cfg.code_sigma_m, 1.5)

    for _it in range(cfg.max_iter):
        rows_a, rows_r, rows_w = [], [], []
        for k, (tow, obs) in enumerate(use):
            xk = x_pos[k] if kinematic else x_pos
            if cfg.tides_week is not None:
                # solid-earth tide displacement of the antenna: the
                # MODELED geometry uses the displaced position; the
                # estimated x stays the mean (tide-free) position
                from .tides import tide_displacement

                xk = xk + tide_displacement(cfg.tides_week, tow, xk)
            lat, lon, hgt = ecef_to_llh(xk)
            dry = (_dry_ztd_m(lat, hgt)
                   if cfg.trop_model == "saastamoinen" else 0.0)
            for prn, o in obs.items():
                spos, sclk = _sat_state(
                    ephemerides[prn], tow, o.pseudorange_m)
                rho = float(np.linalg.norm(spos - xk))
                e = (xk - spos) / rho
                az, el = az_el(xk, spos)
                if np.degrees(el) < cfg.el_mask_deg:
                    continue
                m = _map_el(el)
                trop = dry * m + (ztd_w * m if estimate_ztd else 0.0)
                base = rho + SPEED_OF_LIGHT_M_S * (dts[k] - sclk) + trop
                j = arc_col[arc_of[(k, prn)]]
                pcol = slice(3 * k, 3 * k + 3) if kinematic else slice(0, 3)

                def new_row():
                    row = np.zeros(n_unk)
                    row[pcol] = e
                    row[n_pos + k] = SPEED_OF_LIGHT_M_S
                    if estimate_ztd:
                        row[ztd_col] = m
                    return row

                if dual:
                    # iono-free code + phase
                    p_if = g1 * o.pseudorange_m - g2 * o.pseudorange2_m
                    l_if = (g1 * (-lam1 * o.carrier_phase_cycles)
                            - g2 * (-lam2 * o.carrier_phase2_cycles))
                    row = new_row()
                    rows_a.append(row)
                    rows_r.append(p_if - base)
                    rows_w.append(w_code / m)
                    row = new_row()
                    row[amb0 + j] = 1.0
                    rows_a.append(row)
                    rows_r.append(l_if - (base + amb[j]))
                    rows_w.append(w_phase / m)
                else:
                    # iono-corrected code (fixes the clock datum): IONEX
                    # TEC grid when supplied (rtklib IONOOPT_TEC),
                    # broadcast Klobuchar otherwise
                    ic = 0.0
                    if cfg.tec is not None:
                        d = cfg.tec.delay_m(tow, lat, lon, az, el,
                                            cfg.f1_hz)
                        ic = d if d is not None else 0.0
                    elif cfg.iono is not None:
                        ic = klobuchar_delay_m(cfg.iono, lat, lon, az, el,
                                               tow, cfg.f1_hz)
                    row = new_row()
                    rows_a.append(row)
                    rows_r.append(o.pseudorange_m - ic - base)
                    rows_w.append(w_code_raw / m)
                    # GRAPHIC (P + L)/2: iono-free, carries N*lam/2
                    l_m = -lam1 * o.carrier_phase_cycles
                    gr = 0.5 * (o.pseudorange_m + l_m)
                    row = new_row()
                    row[amb0 + j] = 1.0
                    rows_a.append(row)
                    rows_r.append(gr - (base + amb[j]))
                    # GRAPHIC noise ~ half the code noise
                    rows_w.append(2.0 * w_code / m)
        # kinematic random-walk tie between consecutive epochs
        if kinematic:
            w_rw = 1.0 / max(cfg.kinematic_process_m, 1e-3)
            for k in range(K - 1):
                for ax in range(3):
                    row = np.zeros(n_unk)
                    row[3 * k + ax] = -1.0
                    row[3 * (k + 1) + ax] = 1.0
                    rows_a.append(row)
                    rows_r.append(-(x_pos[k + 1, ax] - x_pos[k, ax]))
                    rows_w.append(w_rw)
        if len(rows_a) < n_unk:
            return inval
        A = np.asarray(rows_a)
        r = np.asarray(rows_r)
        w = np.asarray(rows_w)
        dx, *_ = np.linalg.lstsq(A * w[:, None], r * w, rcond=None)
        if kinematic:
            x_pos = x_pos + dx[:n_pos].reshape(K, 3)
        else:
            x_pos = x_pos + dx[:3]
        dts = dts + dx[n_pos : n_pos + K] # noqa: E203
        if estimate_ztd:
            ztd_w += dx[ztd_col]
        amb = amb + dx[amb0:]
        if np.linalg.norm(dx[:n_pos]) < 1e-4 * max(1, K if kinematic else 1):
            break

    resid = r - A @ dx
    dof = max(1, len(r) - n_unk)
    sigma0 = float(np.sqrt(np.sum((resid * w) ** 2) / dof))
    return PppSolution(
        valid=True, mode=cfg.mode,
        rx_ecef_m=(x_pos[-1].copy() if kinematic else x_pos.copy()),
        epoch_positions=(
            [(use[k][0], x_pos[k].copy()) for k in range(K)]
            if kinematic else None),
        ztd_wet_m=float(ztd_w) if estimate_ztd else 0.0,
        clock_bias_s=dts.copy(),
        ambiguities_m={a: float(amb[i]) for a, i in arc_col.items()},
        n_epochs=K, n_arcs=S, sigma0_m=sigma0,
    )
