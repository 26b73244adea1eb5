"""ctypes bindings for the native host runtime (native/libgnss_native.so).

Reference parity: the host-side C cores — type-convert/unpack kernels (volk
type converts, unpack_2bit_samples.cc), the libswiftcnav Viterbi K=7 r=1/2
decoder, CRC-24Q.  Builds on demand with `make -C native`; every entry point
has a NumPy fallback so the framework works without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgnss_native.so"
_lib = None


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.viterbi27_decode.restype = ctypes.c_int64
    lib.crc24q.restype = ctypes.c_uint32
    _lib = lib
    return lib


def have_native() -> bool:
    return _load() is not None


def unpack_planar(raw: np.ndarray, fmt_name: str) -> np.ndarray:
    """Raw item array -> planar float32 [n, 2] via the native kernels
    (NumPy fallback).  fmt_name in {ishort, ibyte, cshort, cbyte, short,
    byte}."""
    lib = _load()
    interleaved = fmt_name in ("ishort", "ibyte", "cshort", "cbyte")
    n = len(raw) // 2 if interleaved else len(raw)
    if lib is not None:
        out = np.empty((n, 2), dtype=np.float32)
        fn = {
            "ishort": lib.unpack_ishort_planar,
            "cshort": lib.unpack_ishort_planar,
            "ibyte": lib.unpack_ibyte_planar,
            "cbyte": lib.unpack_ibyte_planar,
            "short": lib.unpack_short_planar,
            "byte": lib.unpack_byte_planar,
        }[fmt_name]
        raw = np.ascontiguousarray(raw)
        fn(raw.ctypes.data_as(ctypes.c_void_p),
           out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n))
        return out
    # fallback
    out = np.zeros((n, 2), dtype=np.float32)
    if interleaved:
        f = raw[: 2 * n].astype(np.float32).reshape(n, 2)
        out[:] = f
    else:
        out[:, 0] = raw.astype(np.float32)
    return out


# GPS/Galileo convolutional code polynomials (octal 171, 133)
G1_POLY = 0o171
G2_POLY = 0o133


def conv27_encode(bits: np.ndarray, g1: int = G1_POLY, g2: int = G2_POLY
                  ) -> np.ndarray:
    """K=7 r=1/2 convolutional encoder (the inverse of viterbi27) — the
    test/siggen fixture for CNAV/FNAV/INAV symbol streams."""
    reg = 0
    syms = np.empty(2 * len(bits), dtype=np.int64)
    for i, b in enumerate(np.asarray(bits, dtype=np.int64)):
        reg = (int(b) << 6) | (reg >> 1)
        syms[2 * i] = bin(reg & g1).count("1") & 1
        syms[2 * i + 1] = bin(reg & g2).count("1") & 1
    return syms


def viterbi27(soft_syms: np.ndarray, g1: int = G1_POLY, g2: int = G2_POLY
              ) -> tuple[np.ndarray, int]:
    """Soft-decision K=7 r=1/2 Viterbi decode.

    soft_syms: uint8 array of 2*n symbols (0 = strong 0, 255 = strong 1).
    Returns (bits[n], path_metric)."""
    soft = np.ascontiguousarray(soft_syms, dtype=np.uint8)
    n_bits = len(soft) // 2
    lib = _load()
    out = np.empty(n_bits, dtype=np.uint8)
    if lib is not None:
        m = lib.viterbi27_decode(
            soft.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n_bits),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(g1), ctypes.c_int(g2))
        return out, int(m)
    return _viterbi27_py(soft, n_bits, g1, g2)


def _viterbi27_py(soft: np.ndarray, n_bits: int, g1: int, g2: int
                  ) -> tuple[np.ndarray, int]:
    """Vectorized NumPy fallback (same trellis convention as the C kernel)."""
    ns_count = 64
    s = np.arange(ns_count)
    trans = {}
    for bit in (0, 1):
        reg = (bit << 6) | s
        o1 = (np.vectorize(lambda r: bin(r & g1).count("1") & 1)(reg)) * 255
        o2 = (np.vectorize(lambda r: bin(r & g2).count("1") & 1)(reg)) * 255
        nxt = (bit << 5) | (s >> 1)
        trans[bit] = (nxt, o1.astype(np.int64), o2.astype(np.int64))
    inf = 1 << 60
    pm = np.full(ns_count, inf, dtype=np.int64)
    pm[0] = 0
    back = np.zeros((n_bits, ns_count), dtype=np.uint8)
    for t in range(n_bits):
        s0, s1 = int(soft[2 * t]), int(soft[2 * t + 1])
        pm_next = np.full(ns_count, inf, dtype=np.int64)
        for bit in (0, 1):
            nxt, o1, o2 = trans[bit]
            cand = pm + np.abs(o1 - s0) + np.abs(o2 - s1)
            for src in range(ns_count):
                if cand[src] < pm_next[nxt[src]]:
                    pm_next[nxt[src]] = cand[src]
                    back[t, nxt[src]] = (src & 1) | (bit << 1)
        pm = pm_next
    best = int(np.argmin(pm))
    bits = np.empty(n_bits, dtype=np.uint8)
    st = best
    for t in range(n_bits - 1, -1, -1):
        b = back[t, st]
        bits[t] = (b >> 1) & 1
        st = ((st & 31) << 1) | (b & 1)
    return bits, int(pm[best])


def crc24q(data_bytes: bytes | np.ndarray) -> int:
    b = np.frombuffer(bytes(data_bytes), dtype=np.uint8)
    lib = _load()
    if lib is not None:
        return int(lib.crc24q(b.ctypes.data_as(ctypes.c_void_p),
                              ctypes.c_int64(len(b))))
    crc = 0
    for byte in b:
        crc ^= int(byte) << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= 0x1864CFB
        crc &= 0xFFFFFF
    return crc
