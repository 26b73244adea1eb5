"""Galileo E1B I/NAV message layer (Galileo OS SIS ICD, sec 4.3.5).

Reference parity: galileo_telemetry_decoder_gs.cc (page sync, 8x30 block
deinterleaver, Viterbi with inverted G2 branch, CRC) +
galileo_navigation_message.cc (word types 1-5 -> ephemeris/clock/GST).

E1B nominal page = two 1-second parts (even then odd), each 250 symbols:
10-symbol sync pattern + 240 FEC symbols = 120 bits (K=7 r=1/2, G2 branch
inverted per the Galileo convention) after the 8-row x 30-column block
deinterleaver.  A page carries a 128-bit word (data_1[112] in the even part,
data_2[16] in the odd) + OSNMA/SAR/spare + CRC-24Q over 196 bits.

The encoder exists for the test fixtures (the reference leans on gnss-sim);
the decoder is the product path.  It differs from the JAX package's copy
where that one fails: a re-sync after a broken sync word searches forward
only, and a sync found on an odd part pairs from the next part on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.native import G1_POLY, G2_POLY, crc24q, viterbi27

INAV_SYNC = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], dtype=np.int64)
PART_SYMBOLS = 250
DATA_SYMBOLS = 240
PART_BITS = 120


@dataclasses.dataclass
class GalileoEphemeris:
    """Subset of Galileo_Ephemeris (galileo_ephemeris.h)."""

    prn: int = 0
    iod_nav: int = 0
    toe: float = 0.0          # [s], LSB 60
    toc: float = 0.0
    m0: float = 0.0           # semicircles
    e: float = 0.0
    sqrt_a: float = 0.0
    omega0: float = 0.0
    i0: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0    # semicircles/s
    idot: float = 0.0
    delta_n: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    wn: int = 0               # GST week
    tow: float = 0.0          # GST TOW from word 5


def _put(bits, lo, width, value):
    v = int(value) & ((1 << width) - 1)
    for k in range(width):
        bits[lo + width - 1 - k] = (v >> k) & 1


def _get(bits, lo, width, signed=False):
    v = 0
    for b in bits[lo : lo + width]:
        v = (v << 1) | int(b)
    if signed and v & (1 << (width - 1)):
        v -= 1 << width
    return v


def _q(value, scale):
    return int(round(value / (2.0 ** scale)))


def encode_word(wtype: int, eph: GalileoEphemeris) -> np.ndarray:
    """128-bit I/NAV word (types 1-5)."""
    b = np.zeros(128, dtype=np.int64)
    _put(b, 0, 6, wtype)
    if wtype == 1:
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 14, int(eph.toe / 60.0))
        _put(b, 30, 32, _q(eph.m0, -31))
        _put(b, 62, 32, _q(eph.e, -33))
        _put(b, 94, 32, _q(eph.sqrt_a, -19))
    elif wtype == 2:
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 32, _q(eph.omega0, -31))
        _put(b, 48, 32, _q(eph.i0, -31))
        _put(b, 80, 32, _q(eph.omega, -31))
        _put(b, 112, 14, _q(eph.idot, -43))
    elif wtype == 3:
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 24, _q(eph.omega_dot, -43))
        _put(b, 40, 16, _q(eph.delta_n, -43))
        _put(b, 56, 16, _q(eph.cuc, -29))
        _put(b, 72, 16, _q(eph.cus, -29))
        _put(b, 88, 16, _q(eph.crc, -5))
        _put(b, 104, 16, _q(eph.crs, -5))
        _put(b, 120, 8, 107)          # SISA
    elif wtype == 4:
        _put(b, 6, 10, eph.iod_nav)
        _put(b, 16, 6, eph.prn)
        _put(b, 22, 16, _q(eph.cic, -29))
        _put(b, 38, 16, _q(eph.cis, -29))
        _put(b, 54, 14, int(eph.toc / 60.0))
        _put(b, 68, 31, _q(eph.af0, -34))
        _put(b, 99, 21, _q(eph.af1, -46))
        _put(b, 120, 6, _q(eph.af2, -59))
    elif wtype == 5:
        # iono + BGD + health (zeros) then GST
        _put(b, 73, 12, eph.wn)
        _put(b, 85, 20, int(eph.tow))
    return b


def decode_word(b: np.ndarray, eph: GalileoEphemeris) -> int:
    """Parse a 128-bit word into `eph`; returns the word type."""
    wtype = _get(b, 0, 6)
    sc = 2.0
    if wtype == 1:
        eph.iod_nav = _get(b, 6, 10)
        eph.toe = _get(b, 16, 14) * 60.0
        eph.m0 = _get(b, 30, 32, signed=True) * 2.0**-31
        eph.e = _get(b, 62, 32) * 2.0**-33
        eph.sqrt_a = _get(b, 94, 32) * 2.0**-19
    elif wtype == 2:
        eph.iod_nav = _get(b, 6, 10)
        eph.omega0 = _get(b, 16, 32, signed=True) * 2.0**-31
        eph.i0 = _get(b, 48, 32, signed=True) * 2.0**-31
        eph.omega = _get(b, 80, 32, signed=True) * 2.0**-31
        eph.idot = _get(b, 112, 14, signed=True) * 2.0**-43
    elif wtype == 3:
        eph.iod_nav = _get(b, 6, 10)
        eph.omega_dot = _get(b, 16, 24, signed=True) * 2.0**-43
        eph.delta_n = _get(b, 40, 16, signed=True) * 2.0**-43
        eph.cuc = _get(b, 56, 16, signed=True) * 2.0**-29
        eph.cus = _get(b, 72, 16, signed=True) * 2.0**-29
        eph.crc = _get(b, 88, 16, signed=True) * 2.0**-5
        eph.crs = _get(b, 104, 16, signed=True) * 2.0**-5
    elif wtype == 4:
        eph.iod_nav = _get(b, 6, 10)
        eph.prn = _get(b, 16, 6)
        eph.cic = _get(b, 22, 16, signed=True) * 2.0**-29
        eph.cis = _get(b, 38, 16, signed=True) * 2.0**-29
        eph.toc = _get(b, 54, 14) * 60.0
        eph.af0 = _get(b, 68, 31, signed=True) * 2.0**-34
        eph.af1 = _get(b, 99, 21, signed=True) * 2.0**-46
        eph.af2 = _get(b, 120, 6, signed=True) * 2.0**-59
    elif wtype == 5:
        eph.wn = _get(b, 73, 12)
        eph.tow = float(_get(b, 85, 20))
    return wtype


# ---------------- page <-> symbol layer ----------------

def _fec_encode(bits120: np.ndarray) -> np.ndarray:
    """K=7 r=1/2 with the Galileo inverted G2 branch."""
    reg = 0
    syms = np.empty(2 * len(bits120), dtype=np.int64)
    for i, bit in enumerate(bits120):
        reg = (int(bit) << 6) | (reg >> 1)
        syms[2 * i] = bin(reg & G1_POLY).count("1") & 1
        syms[2 * i + 1] = 1 - (bin(reg & G2_POLY).count("1") & 1)
    return syms


def _interleave(syms240: np.ndarray) -> np.ndarray:
    """Write row-wise into 8 rows x 30 cols, read column-wise (ICD block
    interleaver; the receiver reverses it)."""
    return syms240.reshape(8, 30).T.reshape(-1)


def _deinterleave(syms240: np.ndarray) -> np.ndarray:
    return syms240.reshape(30, 8).T.reshape(-1)


def encode_page(word128: np.ndarray, seq_crc_fill: int = 0) -> np.ndarray:
    """One nominal page -> 500 symbols (even part + odd part, incl. sync)."""
    even = np.zeros(PART_BITS, dtype=np.int64)
    odd = np.zeros(PART_BITS, dtype=np.int64)
    even[0] = 0                       # even/odd
    even[1] = 0                       # page type nominal
    even[2:114] = word128[:112]       # data_1
    # tail bits 114..119 zeros
    odd[0] = 1
    odd[1] = 0
    odd[2:18] = word128[112:128]      # data_2
    # osnma(40)+sar(22)+spare(2) = zeros at 18..82
    # CRC over even[0:114] + odd[0:82] = 196 bits
    crc_in = np.concatenate([even[:114], odd[:82]])
    pad = (-len(crc_in)) % 8
    by = np.packbits(np.concatenate(
        [crc_in, np.zeros(pad, np.int64)]).astype(np.uint8)).tobytes()
    crc = crc24q(by)
    _put(odd, 82, 24, crc)
    # ssp/reserved 106..113 zeros, tail 114..119 zeros
    parts = []
    for part in (even, odd):
        syms = _interleave(_fec_encode(part))
        parts.append(np.concatenate([INAV_SYNC, syms]))
    return np.concatenate(parts)


def check_page_crc(even: np.ndarray, odd: np.ndarray) -> bool:
    crc_in = np.concatenate([even[:114], odd[:82]])
    pad = (-len(crc_in)) % 8
    by = np.packbits(np.concatenate(
        [crc_in, np.zeros(pad, np.int64)]).astype(np.uint8)).tobytes()
    return crc24q(by) == _get(odd, 82, 24)


def decode_part(syms240: np.ndarray) -> np.ndarray:
    """240 soft symbols (uint8) -> 120 bits (deinterleave + Viterbi with the
    G2 branch un-inverted)."""
    s = np.asarray(_deinterleave(np.asarray(syms240)), dtype=np.int64)
    s = s.copy()
    s[1::2] = 255 - s[1::2]          # undo the inverted branch
    bits, _ = viterbi27(s.astype(np.uint8))
    return bits.astype(np.int64)


def to_keplerian(geph: GalileoEphemeris):
    """GalileoEphemeris -> the GPS-style Keplerian record used by
    pvt.ephemeris (Galileo broadcasts the same parameterization; GM/omega_e
    differences are at the 1e-9 relative level of the shared WGS/GTRF
    constants)."""
    from .lnav import GpsEphemeris

    return GpsEphemeris(
        prn=geph.prn, week=geph.wn,
        toc=geph.toc, toe=geph.toe,
        af0=geph.af0, af1=geph.af1, af2=geph.af2, tgd=0.0,
        iodc=geph.iod_nav, iode=geph.iod_nav,
        sqrt_a=geph.sqrt_a, e=geph.e, m0=geph.m0,
        delta_n=geph.delta_n, omega0=geph.omega0, i0=geph.i0,
        omega=geph.omega, omega_dot=geph.omega_dot, idot=geph.idot,
        cuc=geph.cuc, cus=geph.cus, crc=geph.crc, crs=geph.crs,
        cic=geph.cic, cis=geph.cis,
    )


class InavDecoder:
    """Per-channel E1B I/NAV decoder: one prompt per 4 ms epoch = 1 symbol."""

    def __init__(self, prn: int = 0):
        self.prn = prn
        self._soft: list[float] = []
        self.ephemeris = GalileoEphemeris(prn=prn)
        self.aux = InavAux()          # iono/UTC/almanac (words 5-10)
        self.words: set[int] = set()
        self.page_sync = False
        self._sync_offset: int | None = None
        self._polarity = 1.0
        self._tow_symbol: int | None = None
        self._tow_s: float | None = None
        self._decoded_until = 0

    @property
    def ephemeris_complete(self) -> bool:
        return {1, 2, 3, 4}.issubset(self.words)

    def tow_at_symbol(self, symbol_idx: int) -> float | None:
        if self._tow_s is None:
            return None
        return self._tow_s + 0.004 * (symbol_idx - self._tow_symbol)

    def push(self, prompt_i) -> None:
        self._soft.extend(np.asarray(prompt_i, dtype=np.float64))
        if not self.page_sync:
            self._find_sync(self._decoded_until)
        if self.page_sync:
            self._decode_pages()

    def _find_sync(self, start: int = 0) -> None:
        """Page sync: the first symbol at or after `start` where the sync
        word repeats every part for two more parts, in either polarity.
        A re-sync searches only from where decoding stopped: searching the
        whole history again (the JAX package's decoder) finds the old sync,
        re-decodes up to the same break and loops there for ever."""
        s = np.sign(np.asarray(self._soft[start:]))
        if len(s) < 2 * PART_SYMBOLS + 10:
            return
        pat = 1.0 - 2.0 * INAV_SYNC
        for pol in (1.0, -1.0):
            c = np.correlate(pol * s, pat, mode="valid")
            hits = np.nonzero(c == 10.0)[0]
            for h in hits:
                later = hits[(hits > h) & ((hits - h) % PART_SYMBOLS == 0)]
                if len(later) >= 2:
                    self.page_sync = True
                    self._sync_offset = start + int(h)
                    self._polarity = pol
                    self._decoded_until = start + int(h)
                    return

    def _decode_pages(self) -> None:
        soft = np.asarray(self._soft)
        while len(soft) >= self._decoded_until + 2 * PART_SYMBOLS:
            i = self._decoded_until
            parts = []
            ok = True
            for k in range(2):
                seg = soft[i + k * PART_SYMBOLS : i + (k + 1) * PART_SYMBOLS]
                observed = ((self._polarity * seg[:10]) < 0).astype(np.int64)
                if not np.array_equal(observed, INAV_SYNC):
                    ok = False
                    break
                scale = np.median(np.abs(seg)) or 1.0
                s = np.clip(128 - 127 * (self._polarity * seg[10:]) / (3 * scale),
                            0, 255)
                parts.append(decode_part(s.astype(np.uint8)))
            if not ok:
                # lost page lock: re-search from here on
                self.page_sync = False
                self._find_sync(i + 1)
                if not self.page_sync:
                    return
                continue
            even, odd = parts
            if even[0] == 1:
                # synced on an odd part: these are the halves of two pages;
                # pair from the next part on (the JAX package's decoder
                # swaps them and never decodes)
                self._decoded_until += PART_SYMBOLS
                continue
            if check_page_crc(even, odd):
                word = np.concatenate([even[2:114], odd[2:18]])
                wtype = decode_word(word, self.ephemeris)
                if 5 <= wtype <= 10:
                    decode_aux_word(word, self.aux)
                self.words.add(wtype)
                if wtype == 5 and self.ephemeris.tow > 0:
                    # GST TOW corresponds to the START of this page's even
                    # part (our encoder convention; anchors the symbol clock)
                    self._tow_symbol = i
                    self._tow_s = self.ephemeris.tow
            self._decoded_until += 2 * PART_SYMBOLS


# ----------------------------------------------------------------------
# Word types 5-10 auxiliary data: iono, GST-UTC, almanac, GST-GPS
# (galileo_navigation_message.cc :730-955; bit tables Galileo_E1.h:165-295,
# positions here 0-based = reference's 1-based minus one)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class GalileoIono:
    """NeQuick-G broadcast coefficients (word 5; Galileo_Iono analogue)."""

    ai0: float = 0.0          # sfu
    ai1: float = 0.0          # sfu/deg
    ai2: float = 0.0          # sfu/deg^2
    region_flags: tuple = (False,) * 5
    valid: bool = False


@dataclasses.dataclass
class GalileoUtc:
    """GST-UTC (word 6) + GST-GPS (word 10) conversion (Galileo_Utc_Model
    + the A_0G/A_1G members the reference keeps in Galileo_Almanac)."""

    a0: float = 0.0
    a1: float = 0.0
    delta_t_ls: int = 0
    t0t: float = 0.0
    wn0t: int = 0
    wn_lsf: int = 0
    dn: int = 0
    delta_t_lsf: int = 0
    a0_g: float = 0.0         # GST-GPS
    a1_g: float = 0.0
    t0_g: float = 0.0
    wn0_g: int = 0
    valid: bool = False


@dataclasses.dataclass
class GalileoAlmanac:
    """Reduced-precision almanac satellite (words 7-10; Galileo_Almanac).
    delta_sqrt_a is relative to sqrt(A_nominal) = sqrt(29600 km);
    delta_i relative to 56 deg; angles in semicircles."""

    prn: int = 0
    ioda: int = 0
    wna: int = 0
    t0a: float = 0.0
    delta_sqrt_a: float = 0.0
    e: float = 0.0
    omega: float = 0.0
    delta_i: float = 0.0
    omega0: float = 0.0
    omega_dot: float = 0.0
    m0: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    e5b_hs: int = 0
    e1b_hs: int = 0


@dataclasses.dataclass
class InavAux:
    """Accumulator for word 5-10 auxiliary data; almanac fragments join
    across word pairs (7+8, 8+9, 9+10) like the reference's flag_almanac_N
    staging."""

    iono: GalileoIono = dataclasses.field(default_factory=GalileoIono)
    utc: GalileoUtc = dataclasses.field(default_factory=GalileoUtc)
    bgd_e1e5a: float = 0.0
    bgd_e1e5b: float = 0.0
    almanacs: dict = dataclasses.field(default_factory=dict)
    _stage: dict = dataclasses.field(default_factory=dict)


def encode_aux_word(wtype: int, aux: InavAux, wn: int = 0,
                    tow: float = 0.0) -> np.ndarray:
    """Encode word types 5/6/7/8/9/10 from an InavAux (test/siggen
    fixture).  Almanac slots: aux._stage['sats'] = [alm1, alm2, alm3]."""
    b = np.zeros(128, dtype=np.int64)
    _put(b, 0, 6, wtype)
    sats = aux._stage.get("sats", [GalileoAlmanac()] * 3)
    a1, a2, a3 = (sats + [GalileoAlmanac()] * 3)[:3]
    if wtype == 5:
        io = aux.iono
        _put(b, 6, 11, _q(io.ai0, -2))
        _put(b, 17, 11, _q(io.ai1, -8))
        _put(b, 28, 14, _q(io.ai2, -15))
        for j, f in enumerate(io.region_flags[:5]):
            _put(b, 42 + j, 1, int(f))
        _put(b, 47, 10, _q(aux.bgd_e1e5a, -32))
        _put(b, 57, 10, _q(aux.bgd_e1e5b, -32))
        _put(b, 73, 12, wn)
        _put(b, 85, 20, int(tow))
    elif wtype == 6:
        u = aux.utc
        _put(b, 6, 32, _q(u.a0, -30))
        _put(b, 38, 24, _q(u.a1, -50))
        _put(b, 62, 8, u.delta_t_ls)
        _put(b, 70, 8, int(u.t0t / 3600.0))
        _put(b, 78, 8, u.wn0t)
        _put(b, 86, 8, u.wn_lsf)
        _put(b, 94, 3, u.dn)
        _put(b, 97, 8, u.delta_t_lsf)
        _put(b, 105, 20, int(tow))
    elif wtype == 7:
        _put(b, 6, 4, a1.ioda)
        _put(b, 10, 2, a1.wna)
        _put(b, 12, 10, int(a1.t0a / 600.0))
        _put(b, 22, 6, a1.prn)
        _put(b, 28, 13, _q(a1.delta_sqrt_a, -9))
        _put(b, 41, 11, _q(a1.e, -16))
        _put(b, 52, 16, _q(a1.omega, -15))
        _put(b, 68, 11, _q(a1.delta_i, -14))
        _put(b, 79, 16, _q(a1.omega0, -15))
        _put(b, 95, 11, _q(a1.omega_dot, -33))
        _put(b, 106, 16, _q(a1.m0, -15))
    elif wtype == 8:
        _put(b, 6, 4, a1.ioda)
        _put(b, 10, 16, _q(a1.af0, -19))
        _put(b, 26, 13, _q(a1.af1, -38))
        _put(b, 39, 2, a1.e5b_hs)
        _put(b, 41, 2, a1.e1b_hs)
        _put(b, 43, 6, a2.prn)
        _put(b, 49, 13, _q(a2.delta_sqrt_a, -9))
        _put(b, 62, 11, _q(a2.e, -16))
        _put(b, 73, 16, _q(a2.omega, -15))
        _put(b, 89, 11, _q(a2.delta_i, -14))
        _put(b, 100, 16, _q(a2.omega0, -15))
        _put(b, 116, 11, _q(a2.omega_dot, -33))
    elif wtype == 9:
        _put(b, 6, 4, a2.ioda)
        _put(b, 10, 2, a2.wna)
        _put(b, 12, 10, int(a2.t0a / 600.0))
        _put(b, 22, 16, _q(a2.m0, -15))
        _put(b, 38, 16, _q(a2.af0, -19))
        _put(b, 54, 13, _q(a2.af1, -38))
        _put(b, 67, 2, a2.e5b_hs)
        _put(b, 69, 2, a2.e1b_hs)
        _put(b, 71, 6, a3.prn)
        _put(b, 77, 13, _q(a3.delta_sqrt_a, -9))
        _put(b, 90, 11, _q(a3.e, -16))
        _put(b, 101, 16, _q(a3.omega, -15))
        _put(b, 117, 11, _q(a3.delta_i, -14))
    elif wtype == 10:
        u = aux.utc
        _put(b, 6, 4, a3.ioda)
        _put(b, 10, 16, _q(a3.omega0, -15))
        _put(b, 26, 11, _q(a3.omega_dot, -33))
        _put(b, 37, 16, _q(a3.m0, -15))
        _put(b, 53, 16, _q(a3.af0, -19))
        _put(b, 69, 13, _q(a3.af1, -38))
        _put(b, 82, 2, a3.e5b_hs)
        _put(b, 84, 2, a3.e1b_hs)
        _put(b, 86, 16, _q(u.a0_g, -35))
        _put(b, 102, 12, _q(u.a1_g, -51))
        _put(b, 114, 8, int(u.t0_g / 3600.0))
        _put(b, 122, 6, u.wn0_g)
    return b


def decode_aux_word(b: np.ndarray, aux: InavAux) -> int:
    """Parse word types 5-10 into `aux`; returns the word type.  Almanac
    satellites complete when both their word fragments have arrived with
    matching IODa."""
    wtype = _get(b, 0, 6)
    st = aux._stage
    if wtype == 5:
        aux.iono = GalileoIono(
            ai0=_get(b, 6, 11) * 2.0**-2,
            ai1=_get(b, 17, 11, signed=True) * 2.0**-8,
            ai2=_get(b, 28, 14, signed=True) * 2.0**-15,
            region_flags=tuple(bool(_get(b, 42 + j, 1)) for j in range(5)),
            valid=True)
        aux.bgd_e1e5a = _get(b, 47, 10, signed=True) * 2.0**-32
        aux.bgd_e1e5b = _get(b, 57, 10, signed=True) * 2.0**-32
    elif wtype == 6:
        gg = aux.utc
        aux.utc = GalileoUtc(
            a0=_get(b, 6, 32, signed=True) * 2.0**-30,
            a1=_get(b, 38, 24, signed=True) * 2.0**-50,
            delta_t_ls=_get(b, 62, 8, signed=True),
            t0t=_get(b, 70, 8) * 3600.0,
            wn0t=_get(b, 78, 8),
            wn_lsf=_get(b, 86, 8),
            dn=_get(b, 94, 3),
            delta_t_lsf=_get(b, 97, 8, signed=True),
            a0_g=gg.a0_g, a1_g=gg.a1_g, t0_g=gg.t0_g, wn0_g=gg.wn0_g,
            valid=True)
    elif wtype == 7:
        st["w7"] = {
            "ioda": _get(b, 6, 4), "wna": _get(b, 10, 2),
            "t0a": _get(b, 12, 10) * 600.0, "prn": _get(b, 22, 6),
            "delta_sqrt_a": _get(b, 28, 13, signed=True) * 2.0**-9,
            "e": _get(b, 41, 11) * 2.0**-16,
            "omega": _get(b, 52, 16, signed=True) * 2.0**-15,
            "delta_i": _get(b, 68, 11, signed=True) * 2.0**-14,
            "omega0": _get(b, 79, 16, signed=True) * 2.0**-15,
            "omega_dot": _get(b, 95, 11, signed=True) * 2.0**-33,
            "m0": _get(b, 106, 16, signed=True) * 2.0**-15}
    elif wtype == 8:
        ioda = _get(b, 6, 4)
        w7 = st.get("w7")
        if w7 is not None and w7["ioda"] == ioda and w7["prn"]:
            aux.almanacs[w7["prn"]] = GalileoAlmanac(
                af0=_get(b, 10, 16, signed=True) * 2.0**-19,
                af1=_get(b, 26, 13, signed=True) * 2.0**-38,
                e5b_hs=_get(b, 39, 2), e1b_hs=_get(b, 41, 2), **w7)
        st["w8"] = {
            "ioda": ioda, "prn": _get(b, 43, 6),
            "delta_sqrt_a": _get(b, 49, 13, signed=True) * 2.0**-9,
            "e": _get(b, 62, 11) * 2.0**-16,
            "omega": _get(b, 73, 16, signed=True) * 2.0**-15,
            "delta_i": _get(b, 89, 11, signed=True) * 2.0**-14,
            "omega0": _get(b, 100, 16, signed=True) * 2.0**-15,
            "omega_dot": _get(b, 116, 11, signed=True) * 2.0**-33}
    elif wtype == 9:
        ioda = _get(b, 6, 4)
        wna = _get(b, 10, 2)
        t0a = _get(b, 12, 10) * 600.0
        w8 = st.get("w8")
        if w8 is not None and w8["ioda"] == ioda and w8["prn"]:
            aux.almanacs[w8["prn"]] = GalileoAlmanac(
                wna=wna, t0a=t0a,
                m0=_get(b, 22, 16, signed=True) * 2.0**-15,
                af0=_get(b, 38, 16, signed=True) * 2.0**-19,
                af1=_get(b, 54, 13, signed=True) * 2.0**-38,
                e5b_hs=_get(b, 67, 2), e1b_hs=_get(b, 69, 2), **w8)
        st["w9"] = {
            "ioda": ioda, "wna": wna, "t0a": t0a, "prn": _get(b, 71, 6),
            "delta_sqrt_a": _get(b, 77, 13, signed=True) * 2.0**-9,
            "e": _get(b, 90, 11) * 2.0**-16,
            "omega": _get(b, 101, 16, signed=True) * 2.0**-15,
            "delta_i": _get(b, 117, 11, signed=True) * 2.0**-14}
    elif wtype == 10:
        ioda = _get(b, 6, 4)
        w9 = st.get("w9")
        if w9 is not None and w9["ioda"] == ioda and w9["prn"]:
            aux.almanacs[w9["prn"]] = GalileoAlmanac(
                omega0=_get(b, 10, 16, signed=True) * 2.0**-15,
                omega_dot=_get(b, 26, 11, signed=True) * 2.0**-33,
                m0=_get(b, 37, 16, signed=True) * 2.0**-15,
                af0=_get(b, 53, 16, signed=True) * 2.0**-19,
                af1=_get(b, 69, 13, signed=True) * 2.0**-38,
                e5b_hs=_get(b, 82, 2), e1b_hs=_get(b, 84, 2), **w9)
        aux.utc.a0_g = _get(b, 86, 16, signed=True) * 2.0**-35
        aux.utc.a1_g = _get(b, 102, 12, signed=True) * 2.0**-51
        aux.utc.t0_g = _get(b, 114, 8) * 3600.0
        aux.utc.wn0_g = _get(b, 122, 6)
    return wtype
