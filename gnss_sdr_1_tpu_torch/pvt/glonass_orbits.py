"""GLONASS satellite position from the broadcast state vector (PZ-90.02).

Reference parity: glonass_gnav_ephemeris.cc (simplified_satellite_position /
RK4 integration) and rtklib_ephemeris.cc geph2pos: the broadcast
(x, v, a_lunisolar) state at tb integrates through the ECEF equations of
motion (central + J2 + earth-rotation + luni-solar terms) with RK4.
"""

from __future__ import annotations

import numpy as np

from .geodesy import ecef_to_llh  # noqa: F401  (re-export convenience)

GLO_GM = 398600.44          # km^3/s^2
GLO_AE = 6378.136           # km
GLO_J2 = 1.0826257e-3
GLO_OMEGA = 7.292115e-5     # rad/s


def _deriv(state: np.ndarray, acc_ls: np.ndarray) -> np.ndarray:
    x, y, z, vx, vy, vz = state
    r2 = x * x + y * y + z * z
    r = np.sqrt(r2)
    gm_r3 = GLO_GM / (r2 * r)
    j2t = 1.5 * GLO_J2 * GLO_GM * GLO_AE**2 / (r2 * r2 * r)
    z2_r2 = z * z / r2
    ax = (-gm_r3 * x - j2t * x * (1.0 - 5.0 * z2_r2)
          + GLO_OMEGA**2 * x + 2.0 * GLO_OMEGA * vy + acc_ls[0])
    ay = (-gm_r3 * y - j2t * y * (1.0 - 5.0 * z2_r2)
          + GLO_OMEGA**2 * y - 2.0 * GLO_OMEGA * vx + acc_ls[1])
    az = (-gm_r3 * z - j2t * z * (3.0 - 5.0 * z2_r2) + acc_ls[2])
    return np.array([vx, vy, vz, ax, ay, az])


def glonass_satpos(eph, t_s: float, step_s: float = 60.0) -> tuple[np.ndarray, np.ndarray]:
    """ECEF position [m] and velocity [m/s] at time-of-day `t_s` (same day
    as tb) by RK4 from the broadcast state at tb."""
    state = np.array([eph.x_km, eph.y_km, eph.z_km,
                      eph.vx_kms, eph.vy_kms, eph.vz_kms])
    acc = np.array([eph.ax_kms2, eph.ay_kms2, eph.az_kms2])
    dt = t_s - eph.tb_s
    n = max(1, int(np.ceil(abs(dt) / step_s)))
    h = dt / n
    for _ in range(n):
        k1 = _deriv(state, acc)
        k2 = _deriv(state + 0.5 * h * k1, acc)
        k3 = _deriv(state + 0.5 * h * k2, acc)
        k4 = _deriv(state + h * k3, acc)
        state = state + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return state[:3] * 1e3, state[3:] * 1e3


def glonass_clock_correction(eph, t_s: float) -> float:
    """SV clock offset [s]: -tau_n + gamma_n * (t - tb)."""
    return -eph.tau_n_s + eph.gamma_n * (t_s - eph.tb_s)
