"""BeiDou B1I / B3I ranging-code generation (BeiDou ICD v3.0, sec 5.2.3).

Reference parity: src/algorithms/libs/beidou_b{1,3}i_signal_processing.cc.
B1I: 2046-chip Gold-like code from two 11-stage registers with per-PRN G2
phase selection.  B3I: 10230-chip truncated code from two 13-stage registers
with per-PRN G2 preset states (ICD data, codes/data/icd_tables.npz) and a
G1 register reset on its short cycle.
"""

from __future__ import annotations

import functools

import numpy as np

from .data import tables

# B1I G2 phase-select stage pairs per PRN (BeiDou ICD Table 5-2), PRN 1..37.
_B1I_PHASE1 = (1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4,
               4, 4, 5, 5, 5, 5, 5, 6, 6, 6, 6, 8, 8, 8, 9, 9, 10)
_B1I_PHASE2 = (3, 4, 5, 6, 8, 9, 10, 11, 7, 4, 5, 6, 8, 9, 10, 11, 5, 6, 8,
               9, 10, 11, 6, 8, 9, 10, 11, 8, 9, 10, 11, 9, 10, 11, 10, 11, 11)

# NH20 secondary code modulating D1 NAV satellites (same bits as GPS L5 NH20)
BEIDOU_NH20 = (1.0 - 2.0 * np.array(
    [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0]
)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def beidou_b1i_code(prn: int) -> np.ndarray:
    """2046-chip B1I code for `prn` (1..37), float32 {+1,-1} (bit 1 -> -1)."""
    if not 1 <= prn <= 37:
        raise ValueError(f"BeiDou PRN must be 1..37, got {prn}")
    n = 2046
    # Registers: index 0 = output end (stage 1) .. index 10 = stage 11;
    # init state 01010101010, shift toward index 0.
    g1_reg = [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0]
    g2_reg = list(g1_reg)
    p1 = _B1I_PHASE1[prn - 1]
    p2 = _B1I_PHASE2[prn - 1]
    chips = np.empty(n, dtype=np.int64)
    for i in range(n):
        g1_out = g1_reg[0]
        g2_out = g2_reg[11 - p1] ^ g2_reg[11 - p2]
        chips[i] = g1_out ^ g2_out
        fb1 = (g1_reg[0] + g1_reg[1] + g1_reg[2] + g1_reg[3] + g1_reg[4]
               + g1_reg[10]) & 1
        fb2 = (g2_reg[0] + g2_reg[2] + g2_reg[3] + g2_reg[6] + g2_reg[7]
               + g2_reg[8] + g2_reg[9] + g2_reg[10]) & 1
        g1_reg = g1_reg[1:] + [fb1]
        g2_reg = g2_reg[1:] + [fb2]
    return (1.0 - 2.0 * chips).astype(np.float32)


@functools.lru_cache(maxsize=64)
def beidou_b3i_code(prn: int) -> np.ndarray:
    """10230-chip B3I code for `prn` (1..63), float32 {+1,-1}.

    G1: 13-stage, all-ones init, output stage = index 0, feedback from
    indices 0,9,10,12, short-cycled back to all-ones when the register hits
    the truncation state.  G2: 13-stage, per-PRN preset state (stored reversed
    in the ICD table), feedback from indices 0,1,3,4,6,7,8,12.  Truncated at
    10230 chips.  Matches beidou_b3i_signal_processing.cc:118-149 semantics.
    """
    presets = tables()["beidou_b3i_g2_presets"]
    if not 1 <= prn <= len(presets):
        raise ValueError(f"B3I PRN must be 1..{len(presets)}, got {prn}")
    n = 10230
    g1_reg = [1] * 13
    g2_reg = [int(b) for b in presets[prn - 1]][::-1]
    reset_state = [0, 0] + [1] * 11
    chips = np.empty(n, dtype=np.int64)
    for i in range(n):
        chips[i] = g1_reg[0] ^ g2_reg[0]
        fb1 = (g1_reg[0] + g1_reg[9] + g1_reg[10] + g1_reg[12]) & 1
        fb2 = (g2_reg[0] + g2_reg[1] + g2_reg[3] + g2_reg[4] + g2_reg[6]
               + g2_reg[7] + g2_reg[8] + g2_reg[12]) & 1
        g1_reg = g1_reg[1:] + [fb1]
        g2_reg = g2_reg[1:] + [fb2]
        if g1_reg == reset_state:
            g1_reg = [1] * 13
    return (1.0 - 2.0 * chips).astype(np.float32)
