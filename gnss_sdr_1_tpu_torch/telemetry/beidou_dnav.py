"""BeiDou B1I/B3I D1 NAV message layer (BeiDou ICD v3.0, sec 5.2).

Reference parity: beidou_b1i_telemetry_decoder_gs.cc (BCH(15,11,1) pairs,
bit interleaving, word assembly decode_word :190) +
beidou_dnav_navigation_message.cc d1_subframe_decoder (field positions and
scale factors from Beidou_DNAV.h:57-153).  D1 NAV at 50 bps (NH20 wiped by
tracking or the channel adapter), 300-bit subframes of ten 30-bit words.

Decoded-word layout matches the reference: each word carries
[11 data | 11 data | 4 parity | 4 parity] after BCH decode + deinterleave
(word 1 is copied raw), so the reference's 1-based field bit positions
apply unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

D1_PREAMBLE = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.int64)
SUBFRAME_BITS = 300

# BCH(15,11) generator x^4 + x + 1
_BCH_GEN = 0b10011


def bch1511_encode(data11: np.ndarray) -> np.ndarray:
    """11 data bits -> 15-bit systematic BCH codeword (data + 4 parity)."""
    reg = 0
    for b in data11:
        reg = (reg << 1) | int(b)
    reg <<= 4
    rem = reg
    for shift in range(14, 3, -1):
        if rem & (1 << shift):
            rem ^= _BCH_GEN << (shift - 4)
    cw = reg | rem
    return np.array([(cw >> (14 - k)) & 1 for k in range(15)], dtype=np.int64)


_SYNDROME_TO_POS: dict[int, int] | None = None


def _syndrome_table() -> dict[int, int]:
    global _SYNDROME_TO_POS
    if _SYNDROME_TO_POS is None:
        tab = {}
        for pos in range(15):
            cw = np.zeros(15, dtype=np.int64)
            cw[pos] = 1
            s = _syndrome(cw)
            tab[s] = pos
        _SYNDROME_TO_POS = tab
    return _SYNDROME_TO_POS


def _syndrome(cw15: np.ndarray) -> int:
    reg = 0
    for b in cw15:
        reg = (reg << 1) | int(b)
    rem = reg
    for shift in range(14, 3, -1):
        if rem & (1 << shift):
            rem ^= _BCH_GEN << (shift - 4)
    return rem & 0xF


def bch1511_decode(cw15: np.ndarray) -> tuple[np.ndarray, bool]:
    """Returns (data11, ok); corrects single-bit errors."""
    cw = np.asarray(cw15, dtype=np.int64).copy()
    s = _syndrome(cw)
    if s != 0:
        pos = _syndrome_table().get(s)
        if pos is None:
            return cw[:11], False
        cw[pos] ^= 1
        if _syndrome(cw) != 0:
            return cw[:11], False
    return cw[:11], True


def interleave_word(cw_a: np.ndarray, cw_b: np.ndarray) -> np.ndarray:
    """Two BCH codewords -> 30-bit interleaved word (a1 b1 a2 b2 ...)."""
    out = np.empty(30, dtype=np.int64)
    out[0::2] = cw_a
    out[1::2] = cw_b
    return out


def deinterleave_word(word30: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return word30[0::2], word30[1::2]


def encode_word(data22: np.ndarray, parity_a=None, parity_b=None,
                first_word: bool = False) -> np.ndarray:
    """22 data bits -> 30-bit TRANSMITTED D1 word.

    Normal words: two BCH(15,11) codewords interleaved.  Word 1 is
    transmitted uninterleaved (the reference copies it raw,
    decode_word :198)."""
    a = bch1511_encode(data22[:11])
    b = bch1511_encode(data22[11:22])
    if first_word:
        return np.concatenate([a, b])
    return interleave_word(a, b)


def decode_word(word30: np.ndarray, first_word: bool = False
                ) -> tuple[np.ndarray, bool]:
    """30-bit transmitted word -> (30-bit decoded-layout word
    [11|11|4par|4par], ok) — reference decode_word :190."""
    if first_word:
        return np.asarray(word30, dtype=np.int64), True
    wa, wb = deinterleave_word(word30)
    a, ok_a = bch1511_decode(wa)
    b, ok_b = bch1511_decode(wb)
    out = np.concatenate([a, b, wa[11:], wb[11:]])
    return out, ok_a and ok_b


# ----------------------------------------------------------------------
# D1 field map: {subframe: {name: (((pos,len),...), lsb, signed)}} with
# 1-based bit positions into the decoded 300-bit layout
# (Beidou_DNAV.h:114-153; angles kept in SEMICIRCLES like GpsEphemeris,
# so the PI factor of the reference's PI_TWO_N* scale factors is omitted)
# ----------------------------------------------------------------------

D1_FIELDS: dict[int, dict[str, tuple[tuple, float, bool]]] = {
    1: {
        "sat_h1": (((43, 1),), 1.0, False),
        "aodc": (((44, 5),), 1.0, False),
        "urai": (((49, 4),), 1.0, False),
        "wn": (((61, 13),), 1.0, False),
        "toc": (((74, 9), (91, 8)), 2.0 ** 3, False),
        "tgd1": (((99, 10),), 0.1e-9, True),
        "tgd2": (((121, 6),), 0.1e-9, True),
        "alpha0": (((127, 8),), 2.0 ** -30, True),
        "alpha1": (((135, 8),), 2.0 ** -27, True),
        "alpha2": (((151, 8),), 2.0 ** -24, True),
        "alpha3": (((159, 8),), 2.0 ** -24, True),
        "beta0": (((167, 6), (181, 2)), 2.0 ** 11, True),
        "beta1": (((183, 8),), 2.0 ** 14, True),
        "beta2": (((191, 8),), 2.0 ** 16, True),
        "beta3": (((199, 4), (211, 4)), 2.0 ** 16, True),
        "a2": (((215, 11),), 2.0 ** -66, True),
        "a0": (((226, 7), (241, 17)), 2.0 ** -33, True),
        "a1": (((258, 5), (271, 17)), 2.0 ** -50, True),
        "aode": (((288, 5),), 1.0, False),
    },
    2: {
        "delta_n": (((43, 10), (61, 6)), 2.0 ** -43, True),
        "cuc": (((67, 16), (91, 2)), 2.0 ** -31, True),
        "m0": (((93, 20), (121, 12)), 2.0 ** -31, True),
        "e": (((133, 10), (151, 22)), 2.0 ** -33, False),
        "cus": (((181, 18),), 2.0 ** -31, True),
        "crc": (((199, 4), (211, 14)), 2.0 ** -6, True),
        "crs": (((225, 8), (241, 10)), 2.0 ** -6, True),
        "sqrt_a": (((251, 12), (271, 20)), 2.0 ** -19, False),
        "toe_msb": (((291, 2),), 1.0, False),
    },
    3: {
        "toe_lsb": (((43, 10), (61, 5)), 1.0, False),
        "i0": (((66, 17), (91, 15)), 2.0 ** -31, True),
        "cic": (((106, 7), (121, 11)), 2.0 ** -31, True),
        "omega_dot": (((132, 11), (151, 13)), 2.0 ** -43, True),
        "cis": (((164, 9), (181, 9)), 2.0 ** -31, True),
        "idot": (((190, 13), (211, 1)), 2.0 ** -43, True),
        "omega0": (((212, 21), (241, 11)), 2.0 ** -31, True),
        "omega": (((252, 11), (271, 21)), 2.0 ** -31, True),
    },
}


def _read_bits(bits300: np.ndarray, spec) -> int:
    v = 0
    for pos, ln in spec:
        for k in range(ln):
            v = (v << 1) | int(bits300[pos - 1 + k])
    return v


def read_field(bits300: np.ndarray, spec, lsb: float, signed: bool) -> float:
    nbits = sum(ln for _, ln in spec)
    v = _read_bits(bits300, spec)
    if signed and v >= (1 << (nbits - 1)):
        v -= 1 << nbits
    return v * lsb


def _write_bits(bits300: np.ndarray, spec, value: int) -> None:
    nbits = sum(ln for _, ln in spec)
    value &= (1 << nbits) - 1
    k = nbits
    for pos, ln in spec:
        for j in range(ln):
            k -= 1
            bits300[pos - 1 + j] = (value >> k) & 1


def write_field(bits300: np.ndarray, spec, lsb: float, signed: bool,
                value: float) -> None:
    v = int(round(value / lsb))
    _write_bits(bits300, spec, v)


@dataclasses.dataclass
class BeidouEphemeris:
    """D1 broadcast ephemeris (beidou_dnav_ephemeris.h analogue) — field
    names/units mirror GpsEphemeris (angles in semicircles) so the Kepler
    propagator serves both; `system='C'` selects the CGCS2000 GM/omega_e."""

    prn: int = 0
    week: int = 0
    toc: float = 0.0
    toe: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    iodc: int = 0
    iode: int = 0
    sqrt_a: float = 0.0
    e: float = 0.0
    m0: float = 0.0
    delta_n: float = 0.0
    omega0: float = 0.0
    i0: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    idot: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    sat_h1: int = 0
    system: str = "C"


@dataclasses.dataclass
class BeidouIono:
    """D1 subframe-1 Klobuchar parameters (alpha/beta).

    Exposes alpha0..3/beta0..3 like GpsIono so pvt.atmosphere's Klobuchar
    evaluates either (Beidou_Dnav_Iono derives from Gps_Iono in the
    reference, beidou_dnav_iono.h)."""

    alpha: tuple = (0.0, 0.0, 0.0, 0.0)
    beta: tuple = (0.0, 0.0, 0.0, 0.0)
    valid: bool = False

    def __getattr__(self, name: str):
        if name.startswith("alpha") and name[5:].isdigit():
            return self.alpha[int(name[5:])]
        if name.startswith("beta") and name[4:].isdigit():
            return self.beta[int(name[4:])]
        raise AttributeError(name)


def d1_fields_for(eph: "BeidouEphemeris", fra_id: int) -> dict[str, float]:
    """Broadcast field dict for encode_subframe_bits from an ephemeris
    (test/siggen fixture — the encoder inverse of DnavDecoder._extract)."""
    if fra_id == 1:
        return {"wn": eph.week, "toc": eph.toc, "tgd1": eph.tgd,
                "a0": eph.af0, "a1": eph.af1, "a2": eph.af2,
                "aodc": eph.iodc, "sat_h1": eph.sat_h1}
    if fra_id == 2:
        return {"delta_n": eph.delta_n, "cuc": eph.cuc, "m0": eph.m0,
                "e": eph.e, "cus": eph.cus, "crc": eph.crc, "crs": eph.crs,
                "sqrt_a": eph.sqrt_a, "toe_msb": int(eph.toe / 8.0) >> 15}
    if fra_id == 3:
        return {"toe_lsb": int(eph.toe / 8.0) & 0x7FFF, "i0": eph.i0,
                "cic": eph.cic, "omega_dot": eph.omega_dot, "cis": eph.cis,
                "idot": eph.idot, "omega0": eph.omega0, "omega": eph.omega}
    return {}


def encode_subframe_bits(fra_id: int, sow_s: float,
                         fields: dict[str, float] | None = None
                         ) -> np.ndarray:
    """Build one TRANSMITTED 300-bit D1 subframe with ICD field placement
    (test/siggen fixture; the inverse of decode_subframe)."""
    layout = np.zeros(SUBFRAME_BITS, dtype=np.int64)
    layout[:11] = D1_PREAMBLE
    _write_bits(layout, ((16, 3),), fra_id)
    sow = int(sow_s)
    _write_bits(layout, ((19, 8), (31, 12)), sow)
    if fields:
        spec_map = D1_FIELDS.get(fra_id, {})
        for name, value in fields.items():
            spec, lsb, signed = spec_map[name]
            write_field(layout, spec, lsb, signed, value)
    # per-word encode: layout words are [11|11|4par|4par]; rebuild parity
    out = []
    for w in range(10):
        word = layout[w * 30 : (w + 1) * 30]
        if w == 0:
            # word 1 is transmitted raw (reference copies it verbatim);
            # fill its 4 parity bits with the BCH parity of bits 16-26
            tx = np.concatenate([word[:26], bch1511_encode(word[15:26])[11:]])
            out.append(tx)
        else:
            out.append(encode_word(word[:22]))
    return np.concatenate(out)


def decode_subframe(bits300: np.ndarray) -> dict | None:
    """Transmitted 300 bits -> {fra_id, sow_s, layout} or None on
    preamble/BCH failure."""
    words = []
    for w in range(10):
        d, ok = decode_word(bits300[w * 30 : (w + 1) * 30], first_word=w == 0)
        if not ok:
            return None
        words.append(d)
    layout = np.concatenate(words)
    if not np.array_equal(layout[:11], D1_PREAMBLE):
        return None
    fra_id = _read_bits(layout, ((16, 3),))
    sow = _read_bits(layout, ((19, 8), (31, 12)))
    return {"fra_id": fra_id, "sow_s": float(sow), "layout": layout}


class DnavDecoder:
    """Per-channel D1 NAV decoder: one prompt per 20 ms bit (NH20 already
    wiped).  Accumulates subframes 1-3 into a BeidouEphemeris
    (beidou_dnav_navigation_message.cc d1_subframe_decoder)."""

    def __init__(self, prn: int = 0):
        self.prn = prn
        self._soft: list[float] = []
        self.subframes: dict[int, dict] = {}
        self.frame_sync = False
        self._polarity = 1.0
        self._decoded_until = 0
        self._tow_symbol: int | None = None
        self._sow_s: float | None = None
        self.ephemeris = BeidouEphemeris(prn=prn)
        self.iono = BeidouIono()
        self.almanacs: dict[int, "BeidouAlmanac"] = {}
        self.utc: "BeidouUtc | None" = None
        self._have: set[int] = set()
        self._toe_msb: float | None = None
        self._toe_lsb: float | None = None

    def push(self, prompt_i) -> None:
        self._soft.extend(np.asarray(prompt_i, dtype=np.float64))
        self._process()

    @property
    def ephemeris_complete(self) -> bool:
        return {1, 2, 3}.issubset(self._have)

    def sow_at_symbol(self, symbol_idx: int) -> float | None:
        if self._sow_s is None:
            return None
        return self._sow_s + 0.02 * (symbol_idx - self._tow_symbol)

    def _extract(self, fra_id: int, layout: np.ndarray, sow: float) -> None:
        f = {}
        for name, (spec, lsb, signed) in D1_FIELDS[fra_id].items():
            f[name] = read_field(layout, spec, lsb, signed)
        eph = self.ephemeris
        if fra_id == 1:
            eph.week = int(f["wn"])
            eph.toc = f["toc"]
            eph.tgd = f["tgd1"]
            eph.af0 = f["a0"]
            eph.af1 = f["a1"]
            eph.af2 = f["a2"]
            eph.iodc = int(f["aodc"])
            eph.sat_h1 = int(f["sat_h1"])
            self.iono = BeidouIono(
                alpha=(f["alpha0"], f["alpha1"], f["alpha2"], f["alpha3"]),
                beta=(f["beta0"], f["beta1"], f["beta2"], f["beta3"]),
                valid=True)
        elif fra_id == 2:
            eph.delta_n = f["delta_n"]
            eph.cuc = f["cuc"]
            eph.m0 = f["m0"]
            eph.e = f["e"]
            eph.cus = f["cus"]
            eph.crc = f["crc"]
            eph.crs = f["crs"]
            eph.sqrt_a = f["sqrt_a"]
            self._toe_msb = f["toe_msb"]
        elif fra_id == 3:
            self._toe_lsb = f["toe_lsb"]
            eph.i0 = f["i0"]
            eph.cic = f["cic"]
            eph.omega_dot = f["omega_dot"]
            eph.cis = f["cis"]
            eph.idot = f["idot"]
            eph.omega0 = f["omega0"]
            eph.omega = f["omega"]
        if self._toe_msb is not None and self._toe_lsb is not None:
            # TOE split: 2 MSBs in sf2, 15 LSBs in sf3, LSB scale 2^3
            eph.toe = (int(self._toe_msb) * (1 << 15)
                       + int(self._toe_lsb)) * 8.0
        if fra_id in (1, 2, 3):
            self._have.add(fra_id)

    def _process(self) -> None:
        s = np.asarray(self._soft)
        if len(s) < SUBFRAME_BITS + 11:
            return
        i = self._decoded_until
        while len(s) >= i + SUBFRAME_BITS:
            decoded = False
            for pol in (1.0, -1.0):
                bits = ((pol * s[i : i + SUBFRAME_BITS]) < 0).astype(np.int64)
                r = decode_subframe(bits)
                if r is not None:
                    self.subframes[r["fra_id"]] = r
                    self.frame_sync = True
                    self._polarity = pol
                    # SOW = transmit time of the START of this subframe
                    self._tow_symbol = i
                    self._sow_s = r["sow_s"]
                    if r["fra_id"] in (1, 2, 3):
                        self._extract(r["fra_id"], r["layout"], r["sow_s"])
                    else:
                        aux = d1_decode_aux_page(r["fra_id"], r["layout"])
                        if isinstance(aux, BeidouAlmanac):
                            self.almanacs[aux.prn] = aux
                        elif isinstance(aux, BeidouUtc):
                            self.utc = aux
                    i += SUBFRAME_BITS
                    decoded = True
                    break
            if not decoded:
                i += 1 if not self.frame_sync else SUBFRAME_BITS
        self._decoded_until = i


# ----------------------------------------------------------------------
# D2 NAV (GEO satellites, PRN 1-5): 500 sps symbols, subframe 1 split
# over 10 pages (beidou_dnav_navigation_message.cc d2_subframe_decoder
# :746-933; bit tables Beidou_DNAV.h:218-291).  Word structure (BCH pairs
# + interleave) is shared with D1, so encode_word/decode_word apply.
# ----------------------------------------------------------------------

# per-page raw fields of D2 subframe 1 (positions into the decoded layout;
# *_msb/*_lsb parts are combined by D2Decoder with the shifts the
# reference applies at :800-899)
D2_PAGE_FIELDS: dict[int, dict[str, tuple[tuple, float, bool]]] = {
    1: {
        "sat_h1": (((47, 1),), 1.0, False),
        "aodc": (((48, 5),), 1.0, False),
        "urai": (((61, 4),), 1.0, False),
        "wn": (((65, 13),), 1.0, False),
        "toc": (((78, 5), (91, 12)), 2.0 ** 3, False),
        "tgd1": (((103, 10),), 0.1e-9, True),
    },
    2: {
        "alpha0": (((47, 6), (61, 2)), 2.0 ** -30, True),
        "alpha1": (((63, 8),), 2.0 ** -27, True),
        "alpha2": (((71, 8),), 2.0 ** -24, True),
        "alpha3": (((79, 4), (91, 4)), 2.0 ** -24, True),
        "beta0": (((95, 8),), 2.0 ** 11, True),
        "beta1": (((103, 8),), 2.0 ** 14, True),
        "beta2": (((111, 2), (121, 6)), 2.0 ** 16, True),
        "beta3": (((127, 8),), 2.0 ** 16, True),
    },
    3: {
        "a0": (((101, 12), (121, 12)), 2.0 ** -33, True),
        "a1_msb": (((133, 4),), 1.0, False),
    },
    4: {
        "a1_lsb": (((47, 6), (61, 12)), 1.0, False),
        "a2": (((73, 10), (91, 1)), 2.0 ** -66, True),
        "aode": (((92, 5),), 1.0, False),
        "delta_n": (((97, 16),), 2.0 ** -43, True),
        "cuc_msb": (((121, 14),), 1.0, False),
    },
    5: {
        "cuc_lsb": (((47, 4),), 1.0, False),
        "m0": (((51, 2), (61, 22), (91, 8)), 2.0 ** -31, True),
        "cus": (((99, 14), (121, 4)), 2.0 ** -31, True),
        "e_msb": (((125, 10),), 1.0, False),
    },
    6: {
        "e_lsb": (((47, 6), (61, 16)), 1.0, False),
        "sqrt_a": (((77, 6), (91, 22), (121, 4)), 2.0 ** -19, False),
        "cic_msb": (((125, 10),), 1.0, False),
    },
    7: {
        "cic_lsb": (((47, 6), (61, 2)), 1.0, False),
        "cis": (((63, 18),), 2.0 ** -31, True),
        "toe": (((81, 2), (91, 15)), 2.0 ** 3, False),
        "i0_msb": (((106, 7), (121, 14)), 1.0, False),
    },
    8: {
        "i0_lsb": (((47, 6), (61, 5)), 1.0, False),
        "crc": (((66, 17), (91, 1)), 2.0 ** -6, True),
        "crs": (((92, 18),), 2.0 ** -6, True),
        "omega_dot_msb": (((110, 3), (121, 16)), 1.0, False),
    },
    9: {
        "omega_dot_lsb": (((47, 5),), 1.0, False),
        "omega0": (((52, 1), (61, 22), (91, 9)), 2.0 ** -31, True),
        "omega_msb": (((100, 13), (121, 14)), 1.0, False),
    },
    10: {
        "omega_lsb": (((47, 5),), 1.0, False),
        "idot": (((52, 1), (61, 13)), 2.0 ** -43, True),
    },
}

# split fields: name -> (msb_page, lsb_page, lsb_shift, total_bits,
#                        scale, signed)
D2_SPLITS = {
    "a1": (3, 4, 18, 22, 2.0 ** -50, True),
    "cuc": (4, 5, 4, 18, 2.0 ** -31, True),
    "e": (5, 6, 22, 32, 2.0 ** -33, False),
    "cic": (6, 7, 8, 18, 2.0 ** -31, True),
    "i0": (7, 8, 11, 32, 2.0 ** -31, True),
    "omega_dot": (8, 9, 5, 24, 2.0 ** -43, True),
    "omega": (9, 10, 5, 32, 2.0 ** -31, True),
}


def d2_fields_for(eph: "BeidouEphemeris", page: int,
                  iono: "BeidouIono | None" = None) -> dict[str, float]:
    """Broadcast field dict for encode_d2_page_bits from an ephemeris
    (siggen/test fixture — inverse of D2Decoder)."""

    def split_parts(name, value_int):
        _, _, shift, nbits, _, _ = D2_SPLITS[name]
        v = value_int & ((1 << nbits) - 1)
        return v >> shift, v & ((1 << shift) - 1)

    def as_int(name, value):
        _, _, _, nbits, scale, signed = D2_SPLITS[name]
        v = int(round(value / scale))
        return v & ((1 << nbits) - 1)

    if page == 1:
        return {"wn": eph.week, "toc": eph.toc, "tgd1": eph.tgd,
                "aodc": eph.iodc, "sat_h1": eph.sat_h1}
    if page == 2 and iono is not None:
        return {"alpha0": iono.alpha[0], "alpha1": iono.alpha[1],
                "alpha2": iono.alpha[2], "alpha3": iono.alpha[3],
                "beta0": iono.beta[0], "beta1": iono.beta[1],
                "beta2": iono.beta[2], "beta3": iono.beta[3]}
    if page == 3:
        msb, _ = split_parts("a1", as_int("a1", eph.af1))
        return {"a0": eph.af0, "a1_msb": msb}
    if page == 4:
        _, a1_lsb = split_parts("a1", as_int("a1", eph.af1))
        cuc_msb, _ = split_parts("cuc", as_int("cuc", eph.cuc))
        return {"a1_lsb": a1_lsb, "a2": eph.af2, "aode": eph.iode,
                "delta_n": eph.delta_n, "cuc_msb": cuc_msb}
    if page == 5:
        _, cuc_lsb = split_parts("cuc", as_int("cuc", eph.cuc))
        e_msb, _ = split_parts("e", as_int("e", eph.e))
        return {"cuc_lsb": cuc_lsb, "m0": eph.m0, "cus": eph.cus,
                "e_msb": e_msb}
    if page == 6:
        _, e_lsb = split_parts("e", as_int("e", eph.e))
        cic_msb, _ = split_parts("cic", as_int("cic", eph.cic))
        return {"e_lsb": e_lsb, "sqrt_a": eph.sqrt_a, "cic_msb": cic_msb}
    if page == 7:
        _, cic_lsb = split_parts("cic", as_int("cic", eph.cic))
        i0_msb, _ = split_parts("i0", as_int("i0", eph.i0))
        return {"cic_lsb": cic_lsb, "cis": eph.cis, "toe": eph.toe,
                "i0_msb": i0_msb}
    if page == 8:
        _, i0_lsb = split_parts("i0", as_int("i0", eph.i0))
        od_msb, _ = split_parts("omega_dot", as_int("omega_dot",
                                                    eph.omega_dot))
        return {"i0_lsb": i0_lsb, "crc": eph.crc, "crs": eph.crs,
                "omega_dot_msb": od_msb}
    if page == 9:
        _, od_lsb = split_parts("omega_dot", as_int("omega_dot",
                                                    eph.omega_dot))
        om_msb, _ = split_parts("omega", as_int("omega", eph.omega))
        return {"omega_dot_lsb": od_lsb, "omega0": eph.omega0,
                "omega_msb": om_msb}
    if page == 10:
        _, om_lsb = split_parts("omega", as_int("omega", eph.omega))
        return {"omega_lsb": om_lsb, "idot": eph.idot}
    return {}


def encode_d2_page_bits(page: int, sow_s: float,
                        fields: dict[str, float] | None = None
                        ) -> np.ndarray:
    """Build one TRANSMITTED 300-bit D2 subframe-1 page (test/siggen
    fixture; inverse of D2Decoder page decode)."""
    layout = np.zeros(SUBFRAME_BITS, dtype=np.int64)
    layout[:11] = D1_PREAMBLE
    _write_bits(layout, ((16, 3),), 1)                  # FraID = 1
    _write_bits(layout, ((19, 8), (31, 12)), int(sow_s))
    _write_bits(layout, ((43, 4),), page)               # Pnum
    if fields:
        spec_map = D2_PAGE_FIELDS[page]
        for name, value in fields.items():
            spec, lsb, signed = spec_map[name]
            write_field(layout, spec, lsb, signed, value)
    out = []
    for w in range(10):
        word = layout[w * 30 : (w + 1) * 30]
        if w == 0:
            tx = np.concatenate([word[:26], bch1511_encode(word[15:26])[11:]])
            out.append(tx)
        else:
            out.append(encode_word(word[:22]))
    return np.concatenate(out)


class D2Decoder:
    """Per-channel D2 NAV decoder (GEO PRNs 1-5): one prompt per 2 ms
    symbol, subframe-1 pages 1-10 accumulated into a BeidouEphemeris.

    The reference telemetry decoder reuses the D1 word machinery for D2
    (beidou_b1i_telemetry_decoder_gs.cc:317-345 switches symbol timing
    only); page dispatch follows d2_subframe_decoder :746-933."""

    SYMBOL_S = 0.002                   # 500 sps

    def __init__(self, prn: int = 0):
        self.prn = prn
        self._soft: list[float] = []
        self.frame_sync = False
        self._decoded_until = 0
        self._tow_symbol: int | None = None
        self._sow_s: float | None = None
        self.ephemeris = BeidouEphemeris(prn=prn)
        self.iono = BeidouIono()
        self._pages: dict[int, dict] = {}
        self._raw: dict[str, float] = {}

    def push(self, prompt_i) -> None:
        self._soft.extend(np.asarray(prompt_i, dtype=np.float64))
        self._process()

    @property
    def ephemeris_complete(self) -> bool:
        return all(p in self._pages for p in range(1, 11))

    def sow_at_symbol(self, symbol_idx: int) -> float | None:
        if self._sow_s is None:
            return None
        return self._sow_s + self.SYMBOL_S * (symbol_idx - self._tow_symbol)

    def _combine_splits(self) -> None:
        eph = self.ephemeris
        r = self._raw
        for name, (pm, pl, shift, nbits, scale, signed) in D2_SPLITS.items():
            if f"{name}_msb" not in r or f"{name}_lsb" not in r:
                continue
            v = (int(r[f"{name}_msb"]) << shift) + int(r[f"{name}_lsb"])
            if signed and v >= (1 << (nbits - 1)):
                v -= 1 << nbits
            setattr(eph, {"a1": "af1"}.get(name, name), v * scale)

    def _extract(self, page: int, layout: np.ndarray) -> None:
        f = {}
        for name, (spec, lsb, signed) in D2_PAGE_FIELDS[page].items():
            f[name] = read_field(layout, spec, lsb, signed)
        eph = self.ephemeris
        if page == 1:
            eph.week = int(f["wn"])
            eph.toc = f["toc"]
            eph.tgd = f["tgd1"]
            eph.iodc = int(f["aodc"])
            eph.sat_h1 = int(f["sat_h1"])
        elif page == 2:
            self.iono = BeidouIono(
                alpha=(f["alpha0"], f["alpha1"], f["alpha2"], f["alpha3"]),
                beta=(f["beta0"], f["beta1"], f["beta2"], f["beta3"]),
                valid=True)
        elif page == 3:
            eph.af0 = f["a0"]
        elif page == 4:
            eph.af2 = f["a2"]
            eph.iode = int(f["aode"])
            eph.delta_n = f["delta_n"]
        elif page == 5:
            eph.m0 = f["m0"]
            eph.cus = f["cus"]
        elif page == 6:
            eph.sqrt_a = f["sqrt_a"]
        elif page == 7:
            eph.cis = f["cis"]
            eph.toe = f["toe"]
        elif page == 8:
            eph.crc = f["crc"]
            eph.crs = f["crs"]
        elif page == 9:
            eph.omega0 = f["omega0"]
        elif page == 10:
            eph.idot = f["idot"]
        for name, v in f.items():
            if name.endswith("_msb") or name.endswith("_lsb"):
                self._raw[name] = v
        self._combine_splits()
        self._pages[page] = f

    def _process(self) -> None:
        s = np.asarray(self._soft)
        if len(s) < SUBFRAME_BITS + 11:
            return
        i = self._decoded_until
        while len(s) >= i + SUBFRAME_BITS:
            decoded = False
            for pol in (1.0, -1.0):
                bits = ((pol * s[i : i + SUBFRAME_BITS]) < 0).astype(np.int64)
                r = decode_subframe(bits)
                if r is not None:
                    fra_id = r["fra_id"]
                    self.frame_sync = True
                    if fra_id == 1:
                        # SOW (integer seconds) anchors TOW only on pages —
                        # the reference sets flag_new_SOW_available only in
                        # d2_subframe_decoder's FraID-1 cases (:768-903)
                        self._tow_symbol = i
                        self._sow_s = r["sow_s"]
                        page = _read_bits(r["layout"], ((43, 4),))
                        if 1 <= page <= 10:
                            self._extract(page, r["layout"])
                    i += SUBFRAME_BITS
                    decoded = True
                    break
            if not decoded:
                i += 1 if not self.frame_sync else SUBFRAME_BITS
        self._decoded_until = i


# ----------------------------------------------------------------------
# D1 subframe 4/5: almanac pages + UTC parameters (Beidou_DNAV.h:94-217;
# beidou_dnav_navigation_message.cc :588-650 page dispatch).  Angles in
# semicircles like BeidouEphemeris (the reference's PI_TWO_N* scales carry
# the pi factor; it is omitted here as everywhere else in this module).
# ----------------------------------------------------------------------

D1_ALM_FIELDS: dict[str, tuple[tuple, float, bool]] = {
    "sqrt_a": (((51, 2), (61, 22)), 2.0 ** -11, False),
    "a1": (((91, 11),), 2.0 ** -38, True),
    "a0": (((102, 11),), 2.0 ** -20, True),
    "omega0": (((121, 22), (151, 2)), 2.0 ** -23, True),
    "e": (((153, 17),), 2.0 ** -21, False),
    "delta_i": (((170, 3), (181, 13)), 2.0 ** -19, True),
    "toa": (((194, 8),), 2.0 ** 12, False),
    "omega_dot": (((202, 1), (211, 16)), 2.0 ** -38, True),
    "omega": (((227, 6), (241, 18)), 2.0 ** -23, True),
    "m0": (((259, 4), (271, 20)), 2.0 ** -23, True),
}

D1_UTC_FIELDS: dict[str, tuple[tuple, float, bool]] = {
    "delta_t_ls": (((51, 2), (61, 6)), 1.0, True),
    "delta_t_lsf": (((67, 8),), 1.0, True),
    "wn_lsf": (((75, 8),), 1.0, False),
    "a0utc": (((91, 22), (121, 10)), 2.0 ** -30, True),
    "a1utc": (((131, 12), (151, 12)), 2.0 ** -50, True),
    "dn": (((163, 8),), 1.0, False),
}

_D1_PNUM_SPEC = ((44, 7),)


@dataclasses.dataclass
class BeidouAlmanac:
    """D1 almanac page (Beidou_Dnav_Almanac analogue); semicircle angles,
    delta_i relative to the 0.30-semicircle reference inclination."""

    prn: int = 0
    sqrt_a: float = 0.0
    a0: float = 0.0
    a1: float = 0.0
    omega0: float = 0.0
    e: float = 0.0
    delta_i: float = 0.0
    toa: float = 0.0
    omega_dot: float = 0.0
    omega: float = 0.0
    m0: float = 0.0


@dataclasses.dataclass
class BeidouUtc:
    """BDT-UTC correction (Beidou_Dnav_Utc_Model, subframe 5 page 10)."""

    a0: float = 0.0
    a1: float = 0.0
    delta_t_ls: int = 0
    wn_lsf: int = 0
    dn: int = 0
    delta_t_lsf: int = 0
    valid: bool = False


def encode_d1_page_bits(fra_id: int, pnum: int, sow_s: float,
                        fields: dict[str, float],
                        field_map: dict | None = None) -> np.ndarray:
    """Transmitted subframe-4/5 page (almanac or UTC) fixture."""
    layout = np.zeros(SUBFRAME_BITS, dtype=np.int64)
    layout[:11] = D1_PREAMBLE
    _write_bits(layout, ((16, 3),), fra_id)
    _write_bits(layout, ((19, 8), (31, 12)), int(sow_s))
    _write_bits(layout, _D1_PNUM_SPEC, pnum)
    fmap = field_map or (D1_UTC_FIELDS if (fra_id == 5 and pnum == 10)
                         else D1_ALM_FIELDS)
    for name, value in fields.items():
        spec, lsb, signed = fmap[name]
        write_field(layout, spec, lsb, signed, value)
    out = []
    for w in range(10):
        word = layout[w * 30 : (w + 1) * 30]
        if w == 0:
            out.append(np.concatenate(
                [word[:26], bch1511_encode(word[15:26])[11:]]))
        else:
            out.append(encode_word(word[:22]))
    return np.concatenate(out)


def d1_decode_aux_page(fra_id: int, layout: np.ndarray):
    """Subframe 4/5 page -> (BeidouAlmanac | BeidouUtc | None).

    Subframe 4 pages 1-24 carry almanac for PRNs 1-24; subframe 5 pages
    1-6 for PRNs 25-30, page 10 the UTC model (:920-933)."""
    pnum = _read_bits(layout, _D1_PNUM_SPEC)
    if fra_id == 5 and pnum == 10:
        f = {name: read_field(layout, *spec_lsb_signed)
             for name, spec_lsb_signed in
             ((n, v) for n, v in D1_UTC_FIELDS.items())}
        return BeidouUtc(a0=f["a0utc"], a1=f["a1utc"],
                         delta_t_ls=int(f["delta_t_ls"]),
                         wn_lsf=int(f["wn_lsf"]), dn=int(f["dn"]),
                         delta_t_lsf=int(f["delta_t_lsf"]), valid=True)
    prn = None
    if fra_id == 4 and 1 <= pnum <= 24:
        prn = pnum
    elif fra_id == 5 and 1 <= pnum <= 6:
        prn = 24 + pnum
    if prn is None:
        return None
    f = {name: read_field(layout, *spec) for name, spec in
         D1_ALM_FIELDS.items()}
    if f["sqrt_a"] == 0.0:
        return None               # empty page
    return BeidouAlmanac(prn=prn, **f)
