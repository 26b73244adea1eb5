"""Galileo E5a code generation (Galileo OS SIS ICD, sec 4.3.1).

Reference parity: src/algorithms/libs/galileo_e5_signal_processing.cc and the
memory-code tables of Galileo_E5a.h (ICD Annex C data, stored in
codes/data/icd_tables.npz as hex).
"""

from __future__ import annotations

import functools

import numpy as np

from .data import tables
from .galileo_e1 import _hex_to_chips

E5A_CODE_LEN = 10230


def _primary(key: str, prn: int) -> np.ndarray:
    hexes = tables()[key]
    if not 1 <= prn <= len(hexes):
        raise ValueError(f"Galileo PRN must be 1..{len(hexes)}, got {prn}")
    return _hex_to_chips(str(hexes[prn - 1]), E5A_CODE_LEN)


@functools.lru_cache(maxsize=128)
def galileo_e5ai_code(prn: int) -> np.ndarray:
    """10230-chip E5a-I (data) primary code, float32 {+1,-1}."""
    return _primary("galileo_e5ai_hex", prn)


@functools.lru_cache(maxsize=128)
def galileo_e5aq_code(prn: int) -> np.ndarray:
    """10230-chip E5a-Q (pilot) primary code, float32 {+1,-1}."""
    return _primary("galileo_e5aq_hex", prn)


@functools.lru_cache(maxsize=4)
def galileo_e5ai_secondary() -> np.ndarray:
    """CS20 secondary code on the E5a-I data component (same for all PRNs)."""
    bits = np.array([int(b) for b in str(tables()["galileo_e5ai_secondary"])])
    return (1.0 - 2.0 * bits).astype(np.float32)


@functools.lru_cache(maxsize=128)
def galileo_e5aq_secondary(prn: int) -> np.ndarray:
    """CS100 per-PRN secondary code on the E5a-Q pilot component."""
    seqs = tables()["galileo_e5aq_secondary"]
    if not 1 <= prn <= len(seqs):
        raise ValueError(f"E5aQ secondary PRN must be 1..{len(seqs)}, got {prn}")
    bits = np.array([int(b) for b in str(seqs[prn - 1])])
    return (1.0 - 2.0 * bits).astype(np.float32)
