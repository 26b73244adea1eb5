"""PVT: GPS broadcast orbits, geodesy and least-squares positioning (host).

Reference parity: src/algorithms/PVT/ + the embedded RTKLIB fork: iterated
least squares with RAIM fault exclusion (solver).
"""

from .ephemeris import satellite_position_velocity, satellite_clock_correction
from .geodesy import ecef_to_llh, llh_to_ecef, ecef_to_enu, az_el, dops
from .solver import PvtSolution, solve_pvt

__all__ = [
    "satellite_position_velocity", "satellite_clock_correction",
    "ecef_to_llh", "llh_to_ecef", "ecef_to_enu", "az_el", "dops",
    "PvtSolution", "solve_pvt",
]
