"""Atmospheric delay models for single-point positioning.

Reference parity: the reference's PVT path applies these inside the
embedded RTKLIB — `ionmodel()` (Klobuchar broadcast model) and
`tropmodel()` (Saastamoinen) in src/algorithms/libs/rtklib/rtklib_rtkcmn.cc,
called from rtklib_pntpos.cc (ionocorr/tropcorr).  Re-derived here from the
published model equations (IS-GPS-200 20.3.3.5.2.5 / Saastamoinen 1972),
not translated.

All angles in radians unless noted; returns are meters of delay (to be
ADDED to the geometric range prediction / subtracted from the measured
pseudorange residual).
"""

from __future__ import annotations

import numpy as np

from ..constants import SPEED_OF_LIGHT_M_S
from ..telemetry.lnav import GpsIono

GPS_L1_HZ = 1575.42e6


def klobuchar_delay_m(iono: GpsIono, lat_rad: float, lon_rad: float,
                      az_rad: float, el_rad: float, gps_tow_s: float,
                      carrier_freq_hz: float = GPS_L1_HZ) -> float:
    """Klobuchar broadcast ionospheric delay at the given carrier frequency.

    rtklib_rtkcmn.cc ionmodel() parity; the (f_L1/f)^2 scaling for other
    bands mirrors rtklib_pntpos.cc ionocorr's frequency adjustment.
    """
    if el_rad <= 0.0:
        return 0.0
    # semicircle units throughout (the model is specified in semicircles)
    el_sc = el_rad / np.pi
    phi_u = lat_rad / np.pi
    lam_u = lon_rad / np.pi

    psi = 0.0137 / (el_sc + 0.11) - 0.022          # earth-centred angle
    phi_i = phi_u + psi * np.cos(az_rad)           # IPP latitude
    phi_i = np.clip(phi_i, -0.416, 0.416)
    lam_i = lam_u + psi * np.sin(az_rad) / np.cos(phi_i * np.pi)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)  # geomagnetic

    t = 43200.0 * lam_i + gps_tow_s                # local time [s]
    t -= np.floor(t / 86400.0) * 86400.0

    f = 1.0 + 16.0 * (0.53 - el_sc) ** 3           # slant (obliquity) factor

    amp = (iono.alpha0 + phi_m * (iono.alpha1 + phi_m *
           (iono.alpha2 + phi_m * iono.alpha3)))
    per = (iono.beta0 + phi_m * (iono.beta1 + phi_m *
           (iono.beta2 + phi_m * iono.beta3)))
    amp = max(amp, 0.0)
    per = max(per, 72000.0)

    x = 2.0 * np.pi * (t - 50400.0) / per
    if abs(x) < 1.57:
        delay_s = f * (5e-9 + amp * (1.0 + x * x * (-0.5 + x * x / 24.0)))
    else:
        delay_s = f * 5e-9
    scale = (GPS_L1_HZ / carrier_freq_hz) ** 2
    return float(SPEED_OF_LIGHT_M_S * delay_s * scale)


def saastamoinen_delay_m(lat_rad: float, height_m: float, el_rad: float,
                         rel_humidity: float = 0.7) -> float:
    """Saastamoinen tropospheric delay (hydrostatic + wet) with the standard
    atmosphere; rtklib_rtkcmn.cc tropmodel() parity."""
    if el_rad <= 0.0 or height_m < -100.0 or height_m > 1e4:
        return 0.0
    h = max(height_m, 0.0)
    pres = 1013.25 * (1.0 - 2.2557e-5 * h) ** 5.2568      # hPa
    temp = 15.0 - 6.5e-3 * h + 273.16                     # K
    e = 6.108 * rel_humidity * np.exp((17.15 * temp - 4684.0)
                                      / (temp - 38.45))   # hPa
    z = np.pi / 2.0 - el_rad
    trph = (0.0022768 * pres
            / (1.0 - 0.00266 * np.cos(2.0 * lat_rad) - 0.00028 * h / 1e3)
            / np.cos(z))
    trpw = 0.002277 * (1255.0 / temp + 0.05) * e / np.cos(z)
    return float(trph + trpw)
