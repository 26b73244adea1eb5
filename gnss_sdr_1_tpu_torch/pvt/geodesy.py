"""WGS-84 geodesy helpers.

Reference parity: src/algorithms/libs/geofunctions.{h,cc} (cart2geo,
topocent, azebl) and rtklib_rtkcmn.cc (ecef2pos, ecef2enu, dops).
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)


def llh_to_ecef(lat_rad: float, lon_rad: float, h_m: float) -> np.ndarray:
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    return np.array([
        (n + h_m) * cl * np.cos(lon_rad),
        (n + h_m) * cl * np.sin(lon_rad),
        (n * (1.0 - WGS84_E2) + h_m) * sl,
    ])


def ecef_to_llh(xyz: np.ndarray) -> tuple[float, float, float]:
    x, y, z = xyz
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(6):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    h = p / np.cos(lat) - n
    return float(lat), float(lon), float(h)


def enu_matrix(lat_rad: float, lon_rad: float) -> np.ndarray:
    sl, cl = np.sin(lat_rad), np.cos(lat_rad)
    so, co = np.sin(lon_rad), np.cos(lon_rad)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


def ecef_to_enu(ref_xyz: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    lat, lon, _ = ecef_to_llh(ref_xyz)
    return enu_matrix(lat, lon) @ (np.asarray(xyz) - np.asarray(ref_xyz))


def az_el(rx_xyz: np.ndarray, sat_xyz: np.ndarray) -> tuple[float, float]:
    """Azimuth/elevation [rad] of satellite from receiver."""
    enu = ecef_to_enu(rx_xyz, sat_xyz)
    az = np.arctan2(enu[0], enu[1]) % (2.0 * np.pi)
    el = np.arctan2(enu[2], np.hypot(enu[0], enu[1]))
    return float(az), float(el)


def dops(h_geometry: np.ndarray, rx_xyz: np.ndarray) -> dict[str, float]:
    """GDOP/PDOP/HDOP/VDOP/TDOP from the LS geometry matrix (rows = unit
    LOS + clock column)."""
    # pinv: degenerate geometries (repeated lines of sight from multi-band
    # measurements of one SV) must degrade DOPs, not raise
    q = np.linalg.pinv(h_geometry.T @ h_geometry)
    lat, lon, _ = ecef_to_llh(rx_xyz)
    r = enu_matrix(lat, lon)
    qp = r @ q[:3, :3] @ r.T
    return {
        "gdop": float(np.sqrt(np.trace(q))),
        "pdop": float(np.sqrt(np.trace(q[:3, :3]))),
        "hdop": float(np.sqrt(qp[0, 0] + qp[1, 1])),
        "vdop": float(np.sqrt(qp[2, 2])),
        "tdop": float(np.sqrt(q[3, 3])),
    }
