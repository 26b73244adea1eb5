"""Single-point least-squares PVT solver with RAIM fault exclusion.

Reference parity: src/algorithms/PVT/libs/ls_pvt.cc / hybrid_ls_pvt.cc
(iterative LS with earth-rotation and satellite clock handling; Bancroft
init in pvt_solution.cc) and rtklib_pntpos.cc estpos/valsol/raim_fde.
Velocity from Doppler via the same geometry (LS on range rates).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import SPEED_OF_LIGHT_M_S, GPS_OMEGA_EARTH_DOT
from ..telemetry.lnav import GpsEphemeris, GpsIono
from .atmosphere import klobuchar_delay_m, saastamoinen_delay_m
from .ephemeris import satellite_clock_correction, satellite_position_velocity
from .geodesy import az_el, dops, ecef_to_llh

# chi-square(n) 0.999 quantiles, df 1..30 (rtklib_rtkcmn's chisqr table used
# by valsol, rtklib_pntpos.cc:660)
_CHISQR_999 = np.array([
    10.8, 13.8, 16.3, 18.5, 20.5, 22.5, 24.3, 26.1, 27.9, 29.6,
    31.3, 32.9, 34.5, 36.1, 37.7, 39.3, 40.8, 42.3, 43.8, 45.3,
    46.8, 48.3, 49.7, 51.2, 52.6, 54.1, 55.5, 56.9, 58.3, 59.7,
])


@dataclasses.dataclass
class PvtSolution:
    valid: bool
    rx_ecef_m: np.ndarray          # [3]
    rx_clock_bias_s: float
    rx_vel_ecef_ms: np.ndarray     # [3]
    rx_clock_drift_s_s: float
    rx_time_tow_s: float           # corrected receiver TOW
    lat_deg: float = 0.0
    lon_deg: float = 0.0
    height_m: float = 0.0
    dops: dict | None = None
    n_sats: int = 0
    residuals_m: np.ndarray | None = None
    excluded_prns: tuple = ()      # satellites removed by RAIM FDE
    raim_ok: bool = True           # chi-square validation passed


def sat_pos_vel(eph, t: float) -> tuple[np.ndarray, np.ndarray]:
    """Ephemeris-type dispatch: precise products (SP3, pvt.precise) vs
    Keplerian broadcast (GPS/Galileo/BeiDou) vs GLONASS state-vector + RK4
    (rtklib ephpos geph/peph branches, rtklib_ephemeris.cc geph2pos /
    rtklib_preceph.cc peph2pos)."""
    if hasattr(eph, "position_velocity"):
        return eph.position_velocity(t)
    if hasattr(eph, "tb_s"):
        from .glonass_orbits import glonass_satpos

        return glonass_satpos(eph, t)
    return satellite_position_velocity(eph, t)


def sat_clock(eph, t: float) -> float:
    if hasattr(eph, "clock"):
        return eph.clock(t)
    if hasattr(eph, "tb_s"):
        from .glonass_orbits import glonass_clock_correction

        return glonass_clock_correction(eph, t)
    return satellite_clock_correction(eph, t)


def _rotate_earth(pos: np.ndarray, tau: float) -> np.ndarray:
    """Rotate satellite position by earth rotation during signal flight
    (sagnac correction; ls_pvt.cc rot_satpos / rtklib earth rotation)."""
    theta = GPS_OMEGA_EARTH_DOT * tau
    c, s = np.cos(theta), np.sin(theta)
    return np.array([
        c * pos[0] + s * pos[1],
        -s * pos[0] + c * pos[1],
        pos[2],
    ])


def _estimate(
    prns: list[int],
    ephemerides: dict,
    pseudoranges_m: dict[int, float],
    rx_tow_s: float,
    systems: dict[int, str],
    iono,
    apply_tropo: bool,
    el_mask_deg: float,
    weighted: bool,
    carrier_freq_hz: float,
    max_iter: int,
    sat_corr=None,
):
    """One iterated-LS position estimate over `prns` (rtklib estpos).

    Returns None when degenerate, else a dict with the converged state and
    post-fit residuals (used by solve_pvt for RAIM validation / FDE).
    """
    n = len(prns)
    sys_list = sorted({systems.get(p, "G") for p in prns})
    n_sys = len(sys_list)
    sys_col = {s: 3 + k for k, s in enumerate(sys_list)}
    n_unk = 3 + n_sys
    if n < n_unk:
        return None

    pr = np.array([pseudoranges_m[p] for p in prns])
    xyz = np.zeros(3)
    biases = np.zeros(n_sys)
    sat_pos = np.zeros((n, 3))
    sat_vel = np.zeros((n, 3))
    sat_clk = np.zeros(n)
    h = np.zeros((n, n_unk))
    atm = np.zeros(n)
    w = np.ones(n)

    # Satellite states are iteration-invariant: t_tx = rx_tow - bias - tau
    # with tau = pr/c - bias, so the bias cancels exactly (the pseudorange
    # tag carries the same receiver clock) — evaluate the ephemerides ONCE
    # per epoch, as rtklib satposs does, and redo only the cheap Sagnac
    # rotation per iteration (its flight time does depend on the bias).
    sat_pos_raw = np.zeros((n, 3))
    for i, p in enumerate(prns):
        eph = ephemerides[p]
        t_tx = rx_tow_s - pr[i] / SPEED_OF_LIGHT_M_S
        clk = sat_clock(eph, t_tx)
        t_tx -= clk  # broadcast time -> GPS time
        pos, vel = sat_pos_vel(eph, t_tx)
        sat_pos_raw[i] = pos
        sat_vel[i] = vel
        sat_clk[i] = sat_clock(eph, t_tx)

    for _ in range(max_iter):
        for i, p in enumerate(prns):
            bias_i = biases[sys_col[systems.get(p, "G")] - 3]
            tau = pr[i] / SPEED_OF_LIGHT_M_S - bias_i
            sat_pos[i] = _rotate_earth(sat_pos_raw[i], tau + sat_clk[i])
        rho = np.linalg.norm(sat_pos - xyz, axis=1)
        los = (xyz - sat_pos) / rho[:, None]
        h[:] = 0.0
        h[:, :3] = los
        for i, p in enumerate(prns):
            h[i, sys_col[systems.get(p, "G")]] = 1.0
        bias_per_sat = np.array(
            [biases[sys_col[systems.get(p, "G")] - 3] for p in prns])
        pred = rho + SPEED_OF_LIGHT_M_S * (bias_per_sat - sat_clk)
        # Atmospheric corrections + elevation weighting need a position
        # estimate; they engage once the first unaided iteration converges
        # out of the earth's centre (rtklib_pntpos.cc rescode()).
        atm[:] = 0.0
        w[:] = 1.0
        if np.linalg.norm(xyz) > 1e6 and (
                iono is not None or apply_tropo or weighted
                or el_mask_deg > 0.0 or sat_corr is not None):
            lat_r, lon_r, hgt_r = ecef_to_llh(xyz)
            for i in range(n):
                az, el = az_el(xyz, sat_pos[i])
                if iono is not None:
                    atm[i] += klobuchar_delay_m(
                        iono, lat_r, lon_r, az, el, rx_tow_s,
                        carrier_freq_hz)
                if apply_tropo:
                    atm[i] += saastamoinen_delay_m(lat_r, hgt_r, el)
                if sat_corr is not None:
                    # per-satellite external correction (SBAS fast/long-term
                    # + iono grid; rtklib prange()/sbsioncorr chain) — a
                    # callable (prn, az, el, lat, lon, tow) -> meters to
                    # SUBTRACT from the measured pseudorange
                    atm[i] += sat_corr(prns[i], az, el, lat_r, lon_r,
                                       rx_tow_s)
                if el < np.radians(el_mask_deg):
                    w[i] = 0.0
                elif weighted:
                    # rtklib varerr: var = a^2 + b^2/sin(el), a=b=0.3 m
                    w[i] = 1.0 / np.sqrt(0.09 + 0.09 / max(np.sin(el), .05))
            if np.count_nonzero(w) < n_unk:
                return None
        resid = pr - pred - atm
        dx, *_ = np.linalg.lstsq(h * w[:, None], resid * w, rcond=None)
        xyz = xyz + dx[:3]
        biases = biases + dx[3:] / SPEED_OF_LIGHT_M_S
        if np.linalg.norm(dx[:3]) < 1e-4:
            break
    if not np.all(np.isfinite(xyz)):
        return None

    # post-fit residuals at the converged state
    rho = np.linalg.norm(sat_pos - xyz, axis=1)
    bias_per_sat = np.array(
        [biases[sys_col[systems.get(p, "G")] - 3] for p in prns])
    resid = pr - (rho + SPEED_OF_LIGHT_M_S * (bias_per_sat - sat_clk) + atm)
    return {
        "prns": prns, "xyz": xyz, "biases": biases, "h": h, "w": w,
        "resid": resid, "sat_pos": sat_pos, "sat_vel": sat_vel,
        "sat_clk": sat_clk, "n_unk": n_unk, "sys_list": sys_list,
    }


def _valsol(est, sigma_m: float) -> tuple[bool, float]:
    """Chi-square residual validation (rtklib_pntpos.cc valsol :660):
    vv = sum((v_i/sigma)^2) over used measurements vs chisqr[df-1].
    Returns (ok, normalized vv/df); df<1 -> trivially ok."""
    used = est["w"] > 0.0
    df = int(np.count_nonzero(used)) - est["n_unk"]
    if df < 1:
        return True, 0.0
    vv = float(np.sum((est["resid"][used] / sigma_m) ** 2))
    thr = _CHISQR_999[min(df, len(_CHISQR_999)) - 1]
    return vv <= thr, vv / df


def solve_pvt(
    ephemerides: dict[int, GpsEphemeris],
    pseudoranges_m: dict[int, float],
    rx_tow_s: float,
    dopplers_hz: dict[int, float] | None = None,
    carrier_freq_hz: float = 1575.42e6,
    max_iter: int = 10,
    systems: dict[int, str] | None = None,
    iono: GpsIono | None = None,
    apply_tropo: bool = False,
    el_mask_deg: float = 0.0,
    weighted: bool = False,
    raim: bool = True,
    raim_sigma_m: float = 2.5,
    sat_corr=None,
) -> PvtSolution:
    """Iterated LS position (+velocity if Dopplers given) at receiver epoch
    rx_tow_s (the uncorrected receiver clock's TOW when the measurements
    were formed).

    `systems` (optional): prn -> system label for multi-constellation
    solves; each additional system gets its own clock column (the
    inter-system-bias states of rtklib_pntpos).  The reported clock bias is
    the alphabetically-first system's.

    `iono` enables Klobuchar correction, `apply_tropo` Saastamoinen,
    `el_mask_deg` excludes low satellites, `weighted` applies
    elevation-dependent measurement variances — the ionocorr/tropcorr/
    varerr chain of rtklib_pntpos.cc rescode()/estpos().  All engage only
    once an initial (unaided) position estimate exists.

    `raim` enables chi-square residual validation and single-satellite
    fault exclusion (rtklib_pntpos.cc valsol :660 + raim_fde :699): when
    the post-fit residual quadratic form exceeds the 0.999 chi-square
    quantile, each satellite is excluded in turn and the re-solve with the
    smallest passing normalized residual wins.  `raim_sigma_m` is the
    assumed pseudorange noise sigma for the test.

    `sat_corr` (optional): callable (prn, az_rad, el_rad, lat_rad, lon_rad,
    tow_s) -> meters added to the modeled range — the SBAS / external
    correction hook (rtklib prange() sbsioncorr chain).
    """
    prns = [p for p in sorted(pseudoranges_m) if p in ephemerides]
    invalid = PvtSolution(False, np.zeros(3), 0.0, np.zeros(3), 0.0, rx_tow_s)
    if systems is None:
        systems = {p: "G" for p in prns}

    est = _estimate(prns, ephemerides, pseudoranges_m, rx_tow_s, systems,
                    iono, apply_tropo, el_mask_deg, weighted,
                    carrier_freq_hz, max_iter, sat_corr)
    if est is None:
        return invalid

    excluded: tuple = ()
    raim_ok, vv0 = _valsol(est, raim_sigma_m)
    if raim and not raim_ok and len(prns) >= est["n_unk"] + 2:
        # raim_fde: re-solve with each satellite excluded; keep the passing
        # candidate with smallest normalized residual (rtklib_pntpos.cc:699)
        best = None
        best_vv = vv0
        for drop in prns:
            sub = [p for p in prns if p != drop]
            cand = _estimate(sub, ephemerides, pseudoranges_m, rx_tow_s,
                             systems, iono, apply_tropo, el_mask_deg,
                             weighted, carrier_freq_hz, max_iter, sat_corr)
            if cand is None:
                continue
            ok, vv = _valsol(cand, raim_sigma_m)
            if ok and vv < best_vv:
                best, best_vv, best_drop = cand, vv, drop
        if best is not None:
            est = best
            excluded = (best_drop,)
            raim_ok = True

    prns = est["prns"]
    xyz, biases, h = est["xyz"], est["biases"], est["h"]
    sat_vel = est["sat_vel"]
    dt_rx = biases[0]

    vel_xyz = np.zeros(3)
    drift = 0.0
    if dopplers_hz is not None:
        # Measurement model: -lambda*f_d = rho_dot + c*drift_rx
        #                    = (v_sat - v_rx) . e + c*drift_rx
        # with e the rx->sat unit vector = -h[:, :3].  In the h basis
        # (rows [-e, 1]) the unknown [v_rx; c*drift] satisfies
        # h @ u = -(v_sat . e + lambda*f_d).
        lam = SPEED_OF_LIGHT_M_S / carrier_freq_hz
        fd = np.array([dopplers_hz[p] for p in prns])
        e = -h[:, :3]
        sat_rate = np.sum(sat_vel * e, axis=1)
        rhs = -(sat_rate + lam * fd)
        sol, *_ = np.linalg.lstsq(h, rhs, rcond=None)
        vel_xyz = sol[:3]
        drift = sol[3] / SPEED_OF_LIGHT_M_S

    lat, lon, hgt = ecef_to_llh(xyz)
    return PvtSolution(
        valid=True,
        rx_ecef_m=xyz,
        rx_clock_bias_s=dt_rx,
        rx_vel_ecef_ms=vel_xyz,
        rx_clock_drift_s_s=drift,
        rx_time_tow_s=rx_tow_s - dt_rx,
        lat_deg=float(np.degrees(lat)),
        lon_deg=float(np.degrees(lon)),
        height_m=float(hgt),
        dops=dops(h, xyz),
        n_sats=len(prns),
        residuals_m=est["resid"],
        excluded_prns=excluded,
        raim_ok=raim_ok,
    )
