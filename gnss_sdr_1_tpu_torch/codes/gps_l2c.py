"""GPS L2C (L2CM) ranging-code generator (IS-GPS-200, sec 3.3.2.4).

Reference parity: src/algorithms/libs/gps_l2c_signal.cc.  L2CM is a
10230-chip sequence from a 27-stage modular (Galois) shift register; per-PRN
initial states are ICD Table 3-II data (codes/data/icd_tables.npz).

Scope note: the reference implements only the L2CM (data) code — there is
no L2CL generator anywhere in gnss-sdr (gps_l2c_signal.{h,cc} exports
gps_l2c_m_code_gen_* only; the dataless L2CL pilot is never tracked).
This build matches that scope; adding L2CL needs only the Table 3-II
L2CL initial-state column and a 767250-chip run of the same register.
"""

from __future__ import annotations

import functools

import numpy as np

from .data import tables

_L2C_LEN = 10230
# Galois feedback mask, octal 0445112474 (ICD polynomial: taps at
# stages 3,4,5,6,9,11,13,16,19,21,24,27).
_POLY = 0o445112474


@functools.lru_cache(maxsize=64)
def gps_l2cm_code(prn: int) -> np.ndarray:
    """10230-chip L2CM code for `prn` as float32 in {+1,-1} (1 -> -1)."""
    init = tables()["gps_l2cm_init_reg"]
    if not 1 <= prn <= len(init):
        raise ValueError(f"L2CM PRN must be 1..{len(init)}, got {prn}")
    x = int(init[prn - 1])
    chips = np.empty(_L2C_LEN, dtype=np.int64)
    for n in range(_L2C_LEN):
        chips[n] = x & 1
        x = (x >> 1) ^ ((x & 1) * _POLY)
    return (1.0 - 2.0 * chips).astype(np.float32)
