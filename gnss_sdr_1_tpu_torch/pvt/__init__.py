"""PVT: satellite orbits, geodesy, positioning and output formats (host).

Reference parity: src/algorithms/PVT/ + the embedded RTKLIB fork
(SURVEY.md §2.10): iterated least squares with RAIM fault exclusion
(solver), RTK/DGNSS (rtk, rtk_ekf), PPP with precise products (ppp,
precise), IONEX TEC grids (ionex), solid-earth tides (tides), SBAS
corrections (telemetry.sbas), and the RINEX/RTCM/NMEA/KML/GPX/GeoJSON
printers.
"""

from .ephemeris import satellite_position_velocity, satellite_clock_correction
from .geodesy import ecef_to_llh, llh_to_ecef, ecef_to_enu, az_el, dops
from .ionex import TecProduct, read_ionex, write_ionex
from .precise import PreciseEphemeris, Sp3Product, read_sp3, write_sp3
from .solver import PvtSolution, solve_pvt
from .tides import tide_displacement

__all__ = [
    "satellite_position_velocity", "satellite_clock_correction",
    "ecef_to_llh", "llh_to_ecef", "ecef_to_enu", "az_el", "dops",
    "PvtSolution", "solve_pvt",
    "Sp3Product", "PreciseEphemeris", "read_sp3", "write_sp3",
    "TecProduct", "read_ionex", "write_ionex",
    "tide_displacement",
]
