"""GPS L1 C/A Gold code generator (IS-GPS-200, sec 3.3.2.3).

Reference parity: src/algorithms/libs/gps_sdr_signal_processing.cc
(gps_l1_ca_code_gen_complex / _sampled).  Implemented from the ICD
shift-register definition, vectorized in NumPy.
"""

from __future__ import annotations

import functools

import numpy as np

# G2 phase-select taps per PRN (IS-GPS-200 Table 3-I), index = PRN - 1.
# Entries 33..37 are the reserved ground-transmitter codes.
_G2_TAPS: tuple[tuple[int, int], ...] = (
    (2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9),
    (3, 10), (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10),
    (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6),
    (5, 7), (6, 8), (7, 9), (8, 10), (1, 6), (2, 7), (3, 8), (4, 9),
    (5, 10), (4, 10), (1, 7), (2, 8), (4, 10),
)


def _lfsr(taps: tuple[int, ...], n: int = 1023) -> np.ndarray:
    """Run a 10-stage LFSR with feedback from 1-based `taps`; return the
    output sequence (stage 10) as 0/1 ints.  All-ones initial state."""
    reg = np.ones(10, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        out[i] = reg[9]
        fb = 0
        for t in taps:
            fb ^= reg[t - 1]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=64)
def _g1_g2() -> tuple[np.ndarray, np.ndarray]:
    g1 = _lfsr((3, 10))              # G1: 1 + x^3 + x^10
    g2 = _lfsr((2, 3, 6, 8, 9, 10))  # G2: 1 + x^2 + x^3 + x^6 + x^8 + x^9 + x^10
    return g1, g2


@functools.lru_cache(maxsize=64)
def gps_l1ca_code(prn: int) -> np.ndarray:
    """Return the 1023-chip C/A code for `prn` (1..37) as float32 in {+1,-1}.

    Chip value convention: binary 1 -> -1.0, binary 0 -> +1.0 (BPSK mapping
    used throughout the framework; matches the reference's complex(1,0)/-1
    convention in gps_sdr_signal_processing.cc).
    """
    if not 1 <= prn <= len(_G2_TAPS):
        raise ValueError(f"GPS PRN must be 1..{len(_G2_TAPS)}, got {prn}")
    g1, g2 = _g1_g2()
    t1, t2 = _G2_TAPS[prn - 1]
    # Phase-select: delayed G2 = XOR of two register stages == shifted sequence
    # G2i[k] = g2_stage_t1[k] ^ g2_stage_t2[k]; stage j outputs g2 delayed by
    # (10 - j) chips relative to stage 10.
    d1 = np.roll(g2, t1 - 10)  # stage t1 output leads stage 10 by (10 - t1)
    d2 = np.roll(g2, t2 - 10)
    chips = g1 ^ d1 ^ d2
    return np.where(chips == 1, -1.0, 1.0).astype(np.float32)


def gps_l1ca_first10_octal(prn: int) -> int:
    """First 10 chips as an octal number (ICD Table 3-I check column)."""
    bits = (gps_l1ca_code(prn)[:10] < 0).astype(int)
    return int(oct(int("".join(map(str, bits)), 2))[2:])
