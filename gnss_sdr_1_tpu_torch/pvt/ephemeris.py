"""Broadcast-ephemeris satellite position/velocity/clock (IS-GPS-200 20.3.3.4.3).

Reference parity: src/core/system_parameters/gps_ephemeris.cc
(satellitePosition / sv_clock_drift) and rtklib_ephemeris.cc eph2pos.
Angles in the GpsEphemeris dataclass are in SEMICIRCLES as broadcast; they
are converted here with the ICD value of pi.
"""

from __future__ import annotations

import numpy as np

from ..constants import (BDS_GM, BDS_OMEGA_EARTH_DOT, GPS_GM,
                         GPS_OMEGA_EARTH_DOT, GPS_PI, GPS_F_RELATIVISTIC,
                         GPS_WEEK_SECONDS)
from ..telemetry.lnav import GpsEphemeris


def _gm_omega(eph) -> tuple[float, float]:
    """Constellation constants: CGCS2000 for BeiDou ephemerides
    (system='C'), WGS-84 values otherwise (Galileo's GM differs from GPS by
    only 1.5e-7 relative; the reference's eph2pos also uses one MU per
    GPS/GAL and a BDS-specific pair)."""
    if getattr(eph, "system", "G") == "C":
        return BDS_GM, BDS_OMEGA_EARTH_DOT
    return GPS_GM, GPS_OMEGA_EARTH_DOT


def _time_diff(t: float, t_ref: float) -> float:
    """GPS time-of-week difference with week rollover handling."""
    dt = t - t_ref
    if dt > GPS_WEEK_SECONDS / 2:
        dt -= GPS_WEEK_SECONDS
    elif dt < -GPS_WEEK_SECONDS / 2:
        dt += GPS_WEEK_SECONDS
    return dt


def satellite_clock_correction(eph: GpsEphemeris, t_tx: float) -> float:
    """SV clock offset [s] at transmit time t_tx (TOW, s), including the
    relativistic term and TGD (single-frequency L1)."""
    dt = _time_diff(t_tx, eph.toc)
    clk = eph.af0 + eph.af1 * dt + eph.af2 * dt * dt
    # relativistic correction needs eccentric anomaly
    _, _, e_k = _anomalies(eph, t_tx)
    rel = GPS_F_RELATIVISTIC * eph.e * eph.sqrt_a * np.sin(e_k)
    return clk + rel - eph.tgd


def _anomalies(eph: GpsEphemeris, t: float) -> tuple[float, float, float]:
    """(mean anomaly, true anomaly, eccentric anomaly) at TOW t [rad]."""
    gm, _ = _gm_omega(eph)
    a = eph.sqrt_a**2
    n0 = np.sqrt(gm / a**3)
    tk = _time_diff(t, eph.toe)
    n = n0 + eph.delta_n * GPS_PI
    m = eph.m0 * GPS_PI + n * tk
    e_k = m
    for _ in range(20):
        e_next = m + eph.e * np.sin(e_k)
        if abs(e_next - e_k) < 1e-14:
            e_k = e_next
            break
        e_k = e_next
    nu = np.arctan2(np.sqrt(1.0 - eph.e**2) * np.sin(e_k), np.cos(e_k) - eph.e)
    return m, nu, e_k


def satellite_position_velocity(
    eph: GpsEphemeris, t_tx: float
) -> tuple[np.ndarray, np.ndarray]:
    """ECEF position [m] and velocity [m/s] at transmit time t_tx (TOW, s)."""
    gm, omega_e = _gm_omega(eph)
    a = eph.sqrt_a**2
    tk = _time_diff(t_tx, eph.toe)
    _, nu, e_k = _anomalies(eph, t_tx)
    phi = nu + eph.omega * GPS_PI

    du = eph.cus * np.sin(2 * phi) + eph.cuc * np.cos(2 * phi)
    dr = eph.crs * np.sin(2 * phi) + eph.crc * np.cos(2 * phi)
    di = eph.cis * np.sin(2 * phi) + eph.cic * np.cos(2 * phi)

    u = phi + du
    r = a * (1.0 - eph.e * np.cos(e_k)) + dr
    i = eph.i0 * GPS_PI + di + eph.idot * GPS_PI * tk

    x_orb = r * np.cos(u)
    y_orb = r * np.sin(u)

    omega_k = (
        eph.omega0 * GPS_PI
        + (eph.omega_dot * GPS_PI - omega_e) * tk
        - omega_e * eph.toe
    )
    co, so = np.cos(omega_k), np.sin(omega_k)
    ci, si = np.cos(i), np.sin(i)
    pos = np.array([
        x_orb * co - y_orb * ci * so,
        x_orb * so + y_orb * ci * co,
        y_orb * si,
    ])

    # velocity by analytic differentiation (as rtklib eph2pos's numerical
    # twin; analytic form per Remondi)
    n = np.sqrt(gm / a**3) + eph.delta_n * GPS_PI
    e_dot = n / (1.0 - eph.e * np.cos(e_k))
    nu_dot = e_dot * np.sqrt(1.0 - eph.e**2) / (1.0 - eph.e * np.cos(e_k))
    u_dot = nu_dot * (1.0 + 2.0 * (eph.cus * np.cos(2 * phi) - eph.cuc * np.sin(2 * phi)))
    r_dot = a * eph.e * np.sin(e_k) * e_dot + 2.0 * nu_dot * (
        eph.crs * np.cos(2 * phi) - eph.crc * np.sin(2 * phi)
    )
    i_dot = eph.idot * GPS_PI + 2.0 * nu_dot * (
        eph.cis * np.cos(2 * phi) - eph.cic * np.sin(2 * phi)
    )
    omega_k_dot = eph.omega_dot * GPS_PI - omega_e

    x_orb_dot = r_dot * np.cos(u) - r * np.sin(u) * u_dot
    y_orb_dot = r_dot * np.sin(u) + r * np.cos(u) * u_dot

    vel = np.array([
        x_orb_dot * co - y_orb_dot * ci * so + y_orb * si * so * i_dot
        - pos[1] * omega_k_dot,
        x_orb_dot * so + y_orb_dot * ci * co - y_orb * si * co * i_dot
        + pos[0] * omega_k_dot,
        y_orb_dot * si + y_orb * ci * i_dot,
    ])
    return pos, vel
