"""Galileo E1 B/C code generation (Galileo OS SIS ICD, sec 4.3.2).

Reference parity: src/algorithms/libs/galileo_e1_signal_processing.cc and the
memory-code tables of Galileo_E1.h.  E1B/E1C primary codes are 4092-chip
memory codes (ICD Annex C data, stored in codes/data/icd_tables.npz as hex).
The subcarrier is CBOC(6,1,1/11): E1B = alpha*sBOC(1,1) + beta*sBOC(6,1),
E1C = alpha*sBOC(1,1) - beta*sBOC(6,1), alpha=sqrt(10/11), beta=sqrt(1/11).
"""

from __future__ import annotations

import functools

import numpy as np

from .data import tables

E1_CODE_LEN = 4092
_ALPHA = np.sqrt(10.0 / 11.0)
_BETA = np.sqrt(1.0 / 11.0)


def _hex_to_chips(hexstr: str, n: int) -> np.ndarray:
    """ICD hex string -> ±1 chips (bit 1 -> -1), MSB first.

    Handles odd-length hex strings (4092 bits = 1023 hex chars).
    """
    h = hexstr.strip()
    bitstr = bin(int(h, 16))[2:].zfill(len(h) * 4)[:n]
    bits = np.frombuffer(bitstr.encode(), dtype=np.uint8) - ord("0")
    return (1.0 - 2.0 * bits).astype(np.float32)


@functools.lru_cache(maxsize=128)
def galileo_e1b_code(prn: int) -> np.ndarray:
    """4092-chip E1B (data) primary code, float32 {+1,-1}, no subcarrier."""
    hexes = tables()["galileo_e1b_hex"]
    if not 1 <= prn <= len(hexes):
        raise ValueError(f"Galileo PRN must be 1..{len(hexes)}, got {prn}")
    return _hex_to_chips(str(hexes[prn - 1]), E1_CODE_LEN)


@functools.lru_cache(maxsize=128)
def galileo_e1c_code(prn: int) -> np.ndarray:
    """4092-chip E1C (pilot) primary code, float32 {+1,-1}, no subcarrier."""
    hexes = tables()["galileo_e1c_hex"]
    if not 1 <= prn <= len(hexes):
        raise ValueError(f"Galileo PRN must be 1..{len(hexes)}, got {prn}")
    return _hex_to_chips(str(hexes[prn - 1]), E1_CODE_LEN)


@functools.lru_cache(maxsize=4)
def _e1c_secondary() -> np.ndarray:
    bits = np.array([int(b) for b in str(tables()["galileo_e1c_secondary"])])
    return (1.0 - 2.0 * bits).astype(np.float32)


# CS25: the 25-chip E1C secondary code (one per 100 ms pilot epoch)
E1C_SECONDARY = _e1c_secondary()


def galileo_e1_sinboc11(chips: np.ndarray) -> np.ndarray:
    """Apply sinBOC(1,1) subcarrier: 2 samples/chip, pattern (+1,-1) per chip.

    Ref: galileo_e1_code_gen_sinboc11_float (galileo_e1_signal_processing.cc).
    """
    sub = np.array([1.0, -1.0], dtype=np.float32)
    return (chips[:, None] * sub[None, :]).reshape(-1)


def galileo_e1_sinboc61(chips: np.ndarray) -> np.ndarray:
    """Apply sinBOC(6,1) subcarrier: 12 samples/chip, alternating each Ts/12."""
    sub = np.tile(np.array([1.0, -1.0], dtype=np.float32), 6)
    return (chips[:, None] * sub[None, :]).reshape(-1)


def galileo_e1_cboc(chips: np.ndarray, pilot: bool) -> np.ndarray:
    """Apply CBOC(6,1,1/11) at 12 samples/chip (data: +, pilot: -)."""
    b11 = np.repeat(galileo_e1_sinboc11(chips), 6)
    b61 = galileo_e1_sinboc61(chips)
    sign = -1.0 if pilot else 1.0
    return (_ALPHA * b11 + sign * _BETA * b61).astype(np.float32)
