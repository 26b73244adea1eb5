"""GPS L5 I/Q ranging-code generator (IS-GPS-705, sec 3.3.2.2).

Reference parity: src/algorithms/libs/gps_l5_signal.cc.  Each 10230-chip code
is XA xor XB(advance): XA is a 13-stage LFSR (taps 9,10,12,13) short-cycled at
8190 chips; XB (taps 1,3,4,6,7,8,12,13) free-runs with period 8191; the
per-PRN XB advance values are ICD Table 3-I data (codes/data/icd_tables.npz).
Also provides the NH10/NH20 Neuman-Hofman secondary codes.
"""

from __future__ import annotations

import functools

import numpy as np

from .data import tables

_L5_LEN = 10230

# Neuman-Hofman secondary codes (IS-GPS-705): 0 -> +1, 1 -> -1
# NH10 bits: 0000110101
NH10 = (1.0 - 2.0 * np.array([0, 0, 0, 0, 1, 1, 0, 1, 0, 1])).astype(np.float32)
# NH20 bits: 00000100110101001110
NH20 = (1.0 - 2.0 * np.array(
    [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0]
)).astype(np.float32)


# XA is short-cycled: when the register (newest..oldest bit order) reaches
# 1111111111101 it is forced back to all-ones, giving an 8190-chip period
# (IS-GPS-705 sec 3.3.2.2).
_XA_RESET_STATE = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1)


def _lfsr13(
    taps_oldest_1based: tuple[int, ...],
    n: int,
    reset_state: tuple[int, ...] | None,
) -> np.ndarray:
    """13-stage Fibonacci LFSR, all-ones init, output = oldest stage (13).

    `taps_oldest_1based` are feedback stages numbered from the newest bit;
    if the register equals `reset_state` it is forced to all-ones instead of
    shifting (the XA short-cycle rule).
    """
    reg = [1] * 13
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        out[i] = reg[12]
        if reset_state is not None and tuple(reg) == reset_state:
            reg = [1] * 13
        else:
            fb = 0
            for t in taps_oldest_1based:
                fb ^= reg[t - 1]
            reg = [fb] + reg[:-1]
    return out


@functools.lru_cache(maxsize=4)
def _xa_xb() -> tuple[np.ndarray, np.ndarray]:
    xa = _lfsr13((9, 10, 12, 13), _L5_LEN, reset_state=_XA_RESET_STATE)
    xb = _lfsr13((1, 3, 4, 6, 7, 8, 12, 13), _L5_LEN, reset_state=None)
    return xa, xb


def _l5_code(prn: int, which: str) -> np.ndarray:
    init = tables()[f"gps_l5{which}_init_reg"]
    if not 1 <= prn <= len(init):
        raise ValueError(f"L5 PRN must be 1..{len(init)}, got {prn}")
    # NOTE: the reference indexes INIT_REG[prn] (not prn-1) at
    # gps_l5_signal.cc:139 — we match ICD Table 3-I where row 1 is PRN 1.
    adv = int(init[prn - 1])
    xa, xb = _xa_xb()
    n = np.arange(_L5_LEN)
    chips = xa ^ xb[(adv + n) % _L5_LEN]
    return (1.0 - 2.0 * chips).astype(np.float32)


@functools.lru_cache(maxsize=64)
def gps_l5i_code(prn: int) -> np.ndarray:
    """10230-chip L5I data-component code, float32 {+1,-1}."""
    return _l5_code(prn, "i")


@functools.lru_cache(maxsize=64)
def gps_l5q_code(prn: int) -> np.ndarray:
    """10230-chip L5Q pilot-component code, float32 {+1,-1}."""
    return _l5_code(prn, "q")
