"""Galileo E5a F/NAV message layer (Galileo OS SIS ICD, sec 4.2).

Reference parity: galileo_telemetry_decoder_gs.cc (F/NAV branch: 12-symbol
preamble sync, Viterbi with inverted G2, 61-column deinterleaver) +
galileo_fnav_message.cc (page types 1-4 -> ephemeris/clock/GST/iono/UTC).

One F/NAV page = 10 s at 50 symbols/s: 12-symbol preamble 101101110000 +
488 FEC symbols = 244 bits (page type 6 + nav data 208 + CRC-24Q 24 + tail
6) after the 8-row x 61-column block deinterleaver.  The E5a-I data symbol
is 20 ms (one CS20 secondary-code period); the channel adapter wipes CS20
and hands 50 Hz symbols here.

Shares the GalileoEphemeris record with I/NAV (F/NAV broadcasts the same
Keplerian set for E5a users, plus BGD(E1,E5a) and the ai0-2 NeQuick terms).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.native import crc24q, viterbi27
from .inav import GalileoEphemeris, _fec_encode, _get, _put, _q

FNAV_SYNC = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0], dtype=np.int64)
PAGE_SYMBOLS = 500
DATA_SYMBOLS = 488
PAGE_BITS = 244


@dataclasses.dataclass
class FnavExtras:
    """F/NAV-only broadcast terms (galileo_fnav_message.h fields)."""

    bgd_e1e5a: float = 0.0   # s, 2^-32
    ai0: float = 0.0         # 2^-2 sfu
    ai1: float = 0.0         # 2^-8
    ai2: float = 0.0         # 2^-15
    e5a_hs: int = 0
    e5a_dvs: int = 0
    utc_a0: float = 0.0      # 2^-30 s
    utc_a1: float = 0.0      # 2^-50 s/s
    delta_t_ls: int = 0


def encode_page_bits(ptype: int, eph: GalileoEphemeris,
                     extras: FnavExtras | None = None) -> np.ndarray:
    """The 214 pre-CRC bits of one F/NAV page (types 1-4; layouts per
    galileo_fnav_message.cc split_page/page decoders)."""
    ex = extras or FnavExtras()
    b = np.zeros(214, dtype=np.int64)
    _put(b, 0, 6, ptype)
    if ptype == 1:   # SVID, clock, SISA, iono, BGD, health, GST
        _put(b, 6, 6, eph.prn)
        _put(b, 12, 10, eph.iod_nav)
        _put(b, 22, 14, int(eph.toc / 60.0))
        _put(b, 36, 31, _q(eph.af0, -34))
        _put(b, 67, 21, _q(eph.af1, -46))
        _put(b, 88, 6, _q(eph.af2, -59))
        _put(b, 94, 8, 107)                       # SISA
        _put(b, 102, 11, _q(ex.ai0, -2))
        _put(b, 113, 11, _q(ex.ai1, -8))
        _put(b, 124, 14, _q(ex.ai2, -15))
        # region flags 138..142 zeros
        _put(b, 143, 10, _q(ex.bgd_e1e5a, -32))
        _put(b, 153, 2, ex.e5a_hs)
        _put(b, 155, 12, eph.wn)
        _put(b, 167, 20, int(eph.tow))
        _put(b, 187, 1, ex.e5a_dvs)
    elif ptype == 2:  # ephemeris 1/3 + GST
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 32, _q(eph.m0, -31))
        _put(b, 48, 24, _q(eph.omega_dot, -43))
        _put(b, 72, 32, _q(eph.e, -33))
        _put(b, 104, 32, _q(eph.sqrt_a, -19))
        _put(b, 136, 32, _q(eph.omega0, -31))
        _put(b, 168, 14, _q(eph.idot, -43))
        _put(b, 182, 12, eph.wn)
        _put(b, 194, 20, int(eph.tow))
    elif ptype == 3:  # ephemeris 2/3 + GST
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 32, _q(eph.i0, -31))
        _put(b, 48, 32, _q(eph.omega, -31))
        _put(b, 80, 16, _q(eph.delta_n, -43))
        _put(b, 96, 16, _q(eph.cuc, -29))
        _put(b, 112, 16, _q(eph.cus, -29))
        _put(b, 128, 16, _q(eph.crc, -5))
        _put(b, 144, 16, _q(eph.crs, -5))
        _put(b, 160, 14, int(eph.toe / 60.0))
        _put(b, 174, 12, eph.wn)
        _put(b, 186, 20, int(eph.tow))
    elif ptype == 4:  # ephemeris 3/3 + GST-UTC conversion
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 16, _q(eph.cic, -29))
        _put(b, 32, 16, _q(eph.cis, -29))
        _put(b, 48, 32, _q(ex.utc_a0, -30))
        _put(b, 80, 24, _q(ex.utc_a1, -50))
        _put(b, 104, 8, ex.delta_t_ls)
        # t0t/WN0t/WNLSF/DN/dtLSF/t0g/A0G/A1G/WN0G zeros (112..188)
        _put(b, 189, 20, int(eph.tow))
    return b


def decode_page_bits(b: np.ndarray, eph: GalileoEphemeris,
                     extras: FnavExtras | None = None) -> int:
    """Parse the 214 data bits of a CRC-valid page into eph/extras; returns
    the page type."""
    ex = extras if extras is not None else FnavExtras()
    ptype = _get(b, 0, 6)
    if ptype == 1:
        eph.prn = _get(b, 6, 6)
        eph.iod_nav = _get(b, 12, 10)
        eph.toc = _get(b, 22, 14) * 60.0
        eph.af0 = _get(b, 36, 31, signed=True) * 2.0**-34
        eph.af1 = _get(b, 67, 21, signed=True) * 2.0**-46
        eph.af2 = _get(b, 88, 6, signed=True) * 2.0**-59
        ex.ai0 = _get(b, 102, 11) * 2.0**-2
        ex.ai1 = _get(b, 113, 11, signed=True) * 2.0**-8
        ex.ai2 = _get(b, 124, 14, signed=True) * 2.0**-15
        ex.bgd_e1e5a = _get(b, 143, 10, signed=True) * 2.0**-32
        ex.e5a_hs = _get(b, 153, 2)
        eph.wn = _get(b, 155, 12)
        eph.tow = float(_get(b, 167, 20))
        ex.e5a_dvs = _get(b, 187, 1)
    elif ptype == 2:
        eph.iod_nav = _get(b, 6, 10)
        eph.m0 = _get(b, 16, 32, signed=True) * 2.0**-31
        eph.omega_dot = _get(b, 48, 24, signed=True) * 2.0**-43
        eph.e = _get(b, 72, 32) * 2.0**-33
        eph.sqrt_a = _get(b, 104, 32) * 2.0**-19
        eph.omega0 = _get(b, 136, 32, signed=True) * 2.0**-31
        eph.idot = _get(b, 168, 14, signed=True) * 2.0**-43
        eph.wn = _get(b, 182, 12)
        eph.tow = float(_get(b, 194, 20))
    elif ptype == 3:
        eph.iod_nav = _get(b, 6, 10)
        eph.i0 = _get(b, 16, 32, signed=True) * 2.0**-31
        eph.omega = _get(b, 48, 32, signed=True) * 2.0**-31
        eph.delta_n = _get(b, 80, 16, signed=True) * 2.0**-43
        eph.cuc = _get(b, 96, 16, signed=True) * 2.0**-29
        eph.cus = _get(b, 112, 16, signed=True) * 2.0**-29
        eph.crc = _get(b, 128, 16, signed=True) * 2.0**-5
        eph.crs = _get(b, 144, 16, signed=True) * 2.0**-5
        eph.toe = _get(b, 160, 14) * 60.0
        eph.wn = _get(b, 174, 12)
        eph.tow = float(_get(b, 186, 20))
    elif ptype == 4:
        eph.iod_nav = _get(b, 6, 10)
        eph.cic = _get(b, 16, 16, signed=True) * 2.0**-29
        eph.cis = _get(b, 32, 16, signed=True) * 2.0**-29
        ex.utc_a0 = _get(b, 48, 32, signed=True) * 2.0**-30
        ex.utc_a1 = _get(b, 80, 24, signed=True) * 2.0**-50
        ex.delta_t_ls = _get(b, 104, 8, signed=True)
        eph.tow = float(_get(b, 189, 20))
    return ptype


# ---------------- page <-> symbol layer ----------------

def _crc_bits(bits214: np.ndarray) -> int:
    pad = (-len(bits214)) % 8
    by = np.packbits(np.concatenate(
        [np.zeros(pad, np.int64), bits214]).astype(np.uint8)).tobytes()
    return crc24q(by)


def _interleave(syms488: np.ndarray) -> np.ndarray:
    """8 rows x 61 columns, write row-wise read column-wise (ICD 4.2.3)."""
    return syms488.reshape(8, 61).T.reshape(-1)


def _deinterleave(syms488: np.ndarray) -> np.ndarray:
    return syms488.reshape(61, 8).T.reshape(-1)


def encode_page(ptype: int, eph: GalileoEphemeris,
                extras: FnavExtras | None = None) -> np.ndarray:
    """One F/NAV page -> 500 symbols (preamble + interleaved FEC body)."""
    data = encode_page_bits(ptype, eph, extras)
    full = np.zeros(PAGE_BITS, dtype=np.int64)
    full[:214] = data
    _put(full, 214, 24, _crc_bits(data))
    # tail 238..243 zeros
    syms = _interleave(_fec_encode(full))
    return np.concatenate([FNAV_SYNC, syms])


def decode_symbols(syms488: np.ndarray) -> np.ndarray | None:
    """488 soft symbols (uint8) -> 244 bits, or None on CRC failure."""
    s = np.asarray(_deinterleave(np.asarray(syms488)), dtype=np.int64).copy()
    s[1::2] = 255 - s[1::2]            # undo the inverted G2 branch
    bits, _ = viterbi27(s.astype(np.uint8))
    bits = bits.astype(np.int64)
    if _crc_bits(bits[:214]) != _get(bits, 214, 24):
        return None
    return bits


class FnavDecoder:
    """Per-channel E5a F/NAV decoder over 50 Hz secondary-wiped symbols."""

    def __init__(self, prn: int = 0):
        self.prn = prn
        self._soft: list[float] = []
        self.ephemeris = GalileoEphemeris(prn=prn)
        self.extras = FnavExtras()
        self.pages: set[int] = set()
        self.page_sync = False
        self._sync_offset: int | None = None
        self._polarity = 1.0
        self._tow_symbol: int | None = None
        self._tow_s: float | None = None
        self._decoded_until = 0

    @property
    def ephemeris_complete(self) -> bool:
        return {1, 2, 3, 4}.issubset(self.pages)

    def tow_at_symbol(self, symbol_idx: int) -> float | None:
        if self._tow_s is None:
            return None
        return self._tow_s + 0.02 * (symbol_idx - self._tow_symbol)

    def push(self, symbols) -> None:
        self._soft.extend(np.asarray(symbols, dtype=np.float64))
        if not self.page_sync:
            self._find_sync()
        if self.page_sync:
            self._decode_pages()

    def _find_sync(self) -> None:
        s = np.sign(np.asarray(self._soft))
        if len(s) < PAGE_SYMBOLS + 12:
            return
        pat = 1.0 - 2.0 * FNAV_SYNC
        for pol in (1.0, -1.0):
            c = np.correlate(pol * s, pat, mode="valid")
            hits = np.nonzero(c == 12.0)[0]
            for h in hits:
                later = hits[(hits > h) & ((hits - h) % PAGE_SYMBOLS == 0)]
                if len(later) >= 1:
                    self.page_sync = True
                    self._sync_offset = int(h)
                    self._polarity = pol
                    self._decoded_until = int(h)
                    return

    def _decode_pages(self) -> None:
        soft = np.asarray(self._soft)
        while len(soft) >= self._decoded_until + PAGE_SYMBOLS:
            i = self._decoded_until
            seg = soft[i : i + PAGE_SYMBOLS]
            observed = ((self._polarity * seg[:12]) < 0).astype(np.int64)
            if not np.array_equal(observed, FNAV_SYNC):
                self.page_sync = False
                self._find_sync()
                if not self.page_sync:
                    return
                continue
            scale = np.median(np.abs(seg)) or 1.0
            s = np.clip(128 - 127 * (self._polarity * seg[12:]) / (3 * scale),
                        0, 255)
            bits = decode_symbols(s.astype(np.uint8))
            if bits is not None:
                ptype = decode_page_bits(bits[:214], self.ephemeris,
                                         self.extras)
                if ptype in (1, 2, 3, 4):
                    self.pages.add(ptype)
                    if self.ephemeris.tow > 0:
                        # encoder convention: GST TOW = start of this page
                        self._tow_symbol = i
                        self._tow_s = self.ephemeris.tow
            self._decoded_until += PAGE_SYMBOLS
