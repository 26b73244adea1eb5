"""GPS LNAV message bit layer: encode + decode subframes 1-3 (IS-GPS-200).

Reference parity: src/core/system_parameters/gps_navigation_message.cc
(subframe decode, parity via gps_word_parityCheck) — re-implemented from the
ICD with a shared field-layout table driving both the encoder (used by the
test signal generator, which the reference gets from the external gnss-sim
tool) and the decoder (the product path).

Bit conventions: a subframe is 300 bits, 10 words x 30 bits (24 data + 6
parity).  Parity is the (32,26) Hamming code of IS-GPS-200 20.3.5.2 with
D29*/D30* carried from the previous word and data bits transmitted XOR D30*.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LNAV_PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int64)

# Parity equations (IS-GPS-200 Table 20-XIV): data-bit indices (1-based)
# entering each of D25..D30.
_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
# D25..D28 use D29*, D30*, D29*, D30*; D29 uses D30*; D30 uses D29*.
_PARITY_STAR = (0, 1, 0, 1, 1, 0)   # 0 -> D29*, 1 -> D30*


def _parity_bits(d: np.ndarray, d29s: int, d30s: int) -> np.ndarray:
    """Compute D25..D30 from 24 source data bits (already true polarity)."""
    out = np.zeros(6, dtype=np.int64)
    star = (d29s, d30s)
    for i, taps in enumerate(_PARITY_TAPS):
        acc = star[_PARITY_STAR[i]]
        for t in taps:
            acc ^= int(d[t - 1])
        out[i] = acc
    return out


def encode_word(data24: np.ndarray, d29s: int, d30s: int,
                solve_tail: bool = False) -> np.ndarray:
    """Encode one 30-bit word: transmitted bits = data XOR D30*, plus parity.

    If `solve_tail` (words 2 and 10), data bits 23-24 are chosen so that the
    word's D29 = D30 = 0 (ICD 20.3.3.2: the t bits)."""
    d = np.asarray(data24, dtype=np.int64).copy()
    if solve_tail:
        for b23 in (0, 1):
            for b24 in (0, 1):
                d[22], d[23] = b23, b24
                p = _parity_bits(d, d29s, d30s)
                if p[4] == 0 and p[5] == 0:
                    break
            else:
                continue
            break
    p = _parity_bits(d, d29s, d30s)
    tx = np.concatenate([d ^ d30s, p])
    return tx


def parity_check(word30: np.ndarray, d29s: int, d30s: int) -> bool:
    """Validate a received 30-bit word against D29*/D30* (true if clean).
    Mirrors gps_word_parityCheck (gps_navigation_message.cc)."""
    w = np.asarray(word30, dtype=np.int64)
    d = w[:24] ^ d30s                      # restore source bits
    p = _parity_bits(d, d29s, d30s)
    return bool(np.array_equal(p, w[24:]))


def _twoc(value: float, scale: float, nbits: int) -> int:
    """Quantize to two's-complement of nbits at 2^scale LSB.

    Wraps modulo 2^nbits (NOT clamps): the ICD's angular fields are
    semicircles on a circle, so e.g. m0 = 1.93 encodes as -0.07."""
    q = int(round(value / (2.0 ** scale)))
    return q & ((1 << nbits) - 1)


def _uint(value: float, scale: float, nbits: int) -> int:
    q = int(round(value / (2.0 ** scale)))
    return max(0, min((1 << nbits) - 1, q))


def _sbits(x: int, nbits: int) -> int:
    """Sign-extend an nbits two's-complement value."""
    if x & (1 << (nbits - 1)):
        return x - (1 << nbits)
    return x


@dataclasses.dataclass
class GpsEphemeris:
    """GPS LNAV ephemeris + clock (subset of Gps_Ephemeris,
    src/core/system_parameters/gps_ephemeris.h)."""

    prn: int = 0
    week: int = 0
    # clock (subframe 1)
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    iodc: int = 0
    sv_health: int = 0
    # ephemeris (subframes 2-3)
    iode: int = 0
    toe: float = 0.0
    sqrt_a: float = 0.0
    e: float = 0.0
    m0: float = 0.0         # semicircles
    delta_n: float = 0.0    # semicircles/s
    omega0: float = 0.0     # semicircles
    i0: float = 0.0         # semicircles
    omega: float = 0.0      # semicircles
    omega_dot: float = 0.0  # semicircles/s
    idot: float = 0.0       # semicircles/s
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0


@dataclasses.dataclass
class GpsIono:
    """Klobuchar ionospheric model parameters (subframe 4 page 18;
    Gps_Iono in src/core/system_parameters/gps_iono.h, decoded at
    gps_navigation_message.cc subframe 4 SV_ID 56 branch)."""

    alpha0: float = 0.0  # s
    alpha1: float = 0.0  # s/semicircle
    alpha2: float = 0.0  # s/semicircle^2
    alpha3: float = 0.0  # s/semicircle^3
    beta0: float = 0.0   # s
    beta1: float = 0.0
    beta2: float = 0.0
    beta3: float = 0.0
    valid: bool = False


@dataclasses.dataclass
class GpsUtc:
    """UTC correction parameters (subframe 4 page 18; Gps_Utc_Model,
    src/core/system_parameters/gps_utc_model.h)."""

    a0: float = 0.0      # s
    a1: float = 0.0      # s/s
    tot: float = 0.0     # s, reference TOW
    wn_t: int = 0
    delta_t_ls: int = 0  # leap seconds
    wn_lsf: int = 0
    dn: int = 0
    delta_t_lsf: int = 0
    valid: bool = False


@dataclasses.dataclass
class GpsAlmanac:
    """Subframe 4/5 almanac page (IS-GPS-200 20.3.3.5.1.2, Table 20-VI;
    gps_almanac.h / gps_navigation_message.cc subframe 4/5 SV pages).
    Angles in semicircles; delta_i is relative to the 0.30-semicircle
    reference inclination."""

    prn: int = 0
    e: float = 0.0
    toa: float = 0.0
    delta_i: float = 0.0
    omega_dot: float = 0.0
    sv_health: int = 0
    sqrt_a: float = 0.0
    omega0: float = 0.0
    omega: float = 0.0
    m0: float = 0.0
    af0: float = 0.0
    af1: float = 0.0

    def to_ephemeris(self, week: int = 0) -> GpsEphemeris:
        """Almanac -> coarse ephemeris for visible-sat prediction
        (control_thread.cc get_visible_sats :890 builds az/el from almanac
        exactly this way)."""
        return GpsEphemeris(
            prn=self.prn, week=week, toc=self.toa, toe=self.toa,
            af0=self.af0, af1=self.af1,
            sqrt_a=self.sqrt_a, e=self.e, m0=self.m0,
            omega0=self.omega0, i0=0.30 + self.delta_i, omega=self.omega,
            omega_dot=self.omega_dot)


def _pack(fields: list[tuple[int, int]]) -> np.ndarray:
    """fields = [(value, nbits), ...] -> bit array (MSB first), 24*8=240 bits
    for 8 data words."""
    bits = []
    for val, n in fields:
        for k in range(n - 1, -1, -1):
            bits.append((val >> k) & 1)
    return np.asarray(bits, dtype=np.int64)


def _unpack(bits: np.ndarray, widths: list[int]) -> list[int]:
    out, pos = [], 0
    for w in widths:
        v = 0
        for b in bits[pos : pos + w]:
            v = (v << 1) | int(b)
        out.append(v)
        pos += w
    return out


def _almanac_page_words(words: np.ndarray, alm: GpsAlmanac) -> None:
    """Fill words 3-10 with an almanac page (Table 20-VI layout:
    dataID/svID/e | toa/delta_i | omega_dot/health | sqrtA | omega0 |
    omega | M0 | af0msb/af1/af0lsb)."""
    words[2] = _pack([(1, 2), (alm.prn & 0x3F, 6), (_uint(alm.e, -21, 16), 16)])
    words[3] = _pack([(_uint(alm.toa, 12, 8), 8),
                      (_twoc(alm.delta_i, -19, 16), 16)])
    words[4] = _pack([(_twoc(alm.omega_dot, -38, 16), 16),
                      (alm.sv_health & 0xFF, 8)])
    words[5] = _pack([(_uint(alm.sqrt_a, -11, 24), 24)])
    words[6] = _pack([(_twoc(alm.omega0, -23, 24), 24)])
    words[7] = _pack([(_twoc(alm.omega, -23, 24), 24)])
    words[8] = _pack([(_twoc(alm.m0, -23, 24), 24)])
    af0 = _twoc(alm.af0, -20, 11)
    words[9] = _pack([((af0 >> 3) & 0xFF, 8), (_twoc(alm.af1, -38, 11), 11),
                      (af0 & 0x7, 3), (0, 2)])


def _subframe_data_words(sf_id: int, eph: GpsEphemeris, tow_next_s: float,
                         iono: GpsIono | None = None,
                         utc: GpsUtc | None = None,
                         almanac: GpsAlmanac | None = None) -> np.ndarray:
    """Build the 10x24 source data bits of one subframe (before parity)."""
    words = np.zeros((10, 24), dtype=np.int64)
    # Word 1: TLM — preamble + message (zeros) + reserved
    words[0, :8] = LNAV_PREAMBLE
    # Word 2: HOW — 17-bit truncated TOW (units of 6 s, next subframe), flags,
    # subframe id; bits 23-24 solved for parity closure.
    tow17 = int(round(tow_next_s / 6.0)) % (1 << 17)
    how = (tow17 << 7) | (0 << 6) | (0 << 5) | (sf_id << 2)
    words[1] = _pack([(how, 24)])
    if sf_id == 1:
        iodc = eph.iodc & 0x3FF
        words[2] = _pack([
            (eph.week % 1024, 10), (1, 2), (0, 4), (eph.sv_health, 6),
            (iodc >> 8, 2),
        ])
        words[6] = _pack([(0, 16), (_twoc(eph.tgd, -31, 8), 8)])
        words[7] = _pack([(iodc & 0xFF, 8), (_uint(eph.toc, 4, 16), 16)])
        words[8] = _pack([(_twoc(eph.af2, -55, 8), 8), (_twoc(eph.af1, -43, 16), 16)])
        words[9] = _pack([(_twoc(eph.af0, -31, 22), 22), (0, 2)])
    elif sf_id == 2:
        words[2] = _pack([(eph.iode & 0xFF, 8), (_twoc(eph.crs, -5, 16), 16)])
        m0 = _twoc(eph.m0, -31, 32)
        words[3] = _pack([(_twoc(eph.delta_n, -43, 16), 16), (m0 >> 24, 8)])
        words[4] = _pack([(m0 & 0xFFFFFF, 24)])
        ecc = _uint(eph.e, -33, 32)
        words[5] = _pack([(_twoc(eph.cuc, -29, 16), 16), (ecc >> 24, 8)])
        words[6] = _pack([(ecc & 0xFFFFFF, 24)])
        sqa = _uint(eph.sqrt_a, -19, 32)
        words[7] = _pack([(_twoc(eph.cus, -29, 16), 16), (sqa >> 24, 8)])
        words[8] = _pack([(sqa & 0xFFFFFF, 24)])
        words[9] = _pack([(_uint(eph.toe, 4, 16), 16), (0, 1), (0, 5), (0, 2)])
    elif sf_id == 3:
        om0 = _twoc(eph.omega0, -31, 32)
        words[2] = _pack([(_twoc(eph.cic, -29, 16), 16), (om0 >> 24, 8)])
        words[3] = _pack([(om0 & 0xFFFFFF, 24)])
        inc0 = _twoc(eph.i0, -31, 32)
        words[4] = _pack([(_twoc(eph.cis, -29, 16), 16), (inc0 >> 24, 8)])
        words[5] = _pack([(inc0 & 0xFFFFFF, 24)])
        om = _twoc(eph.omega, -31, 32)
        words[6] = _pack([(_twoc(eph.crc, -5, 16), 16), (om >> 24, 8)])
        words[7] = _pack([(om & 0xFFFFFF, 24)])
        words[8] = _pack([(_twoc(eph.omega_dot, -43, 24), 24)])
        words[9] = _pack([
            (eph.iode & 0xFF, 8), (_twoc(eph.idot, -43, 14), 14), (0, 2)
        ])
    elif sf_id in (4, 5) and almanac is not None:
        _almanac_page_words(words, almanac)
    elif sf_id == 4 and iono is not None and utc is not None:
        # Page 18 (SV ID 56): iono + UTC (IS-GPS-200 20.3.3.5.1;
        # gps_navigation_message.cc subframe 4 case, SV_ID 56 branch)
        words[2] = _pack([
            (1, 2), (56, 6),                    # data ID, SV(page) ID
            (_twoc(iono.alpha0, -30, 8), 8),
            (_twoc(iono.alpha1, -27, 8), 8),
        ])
        words[3] = _pack([
            (_twoc(iono.alpha2, -24, 8), 8),
            (_twoc(iono.alpha3, -24, 8), 8),
            (_twoc(iono.beta0, 11, 8), 8),
        ])
        words[4] = _pack([
            (_twoc(iono.beta1, 14, 8), 8),
            (_twoc(iono.beta2, 16, 8), 8),
            (_twoc(iono.beta3, 16, 8), 8),
        ])
        words[5] = _pack([(_twoc(utc.a1, -50, 24), 24)])
        a0 = _twoc(utc.a0, -30, 32)
        words[6] = _pack([(a0 >> 8, 24)])
        words[7] = _pack([
            (a0 & 0xFF, 8), (_uint(utc.tot, 12, 8), 8), (utc.wn_t % 256, 8),
        ])
        words[8] = _pack([
            (_twoc(utc.delta_t_ls, 0, 8), 8), (utc.wn_lsf % 256, 8),
            (utc.dn % 256, 8),
        ])
        words[9] = _pack([(_twoc(utc.delta_t_lsf, 0, 8), 8), (0, 14), (0, 2)])
    else:  # other subframe 4/5 almanac pages — emit valid parity filler
        pass
    return words


def encode_subframe(sf_id: int, eph: GpsEphemeris, tow_next_s: float,
                    d29s: int, d30s: int,
                    iono: GpsIono | None = None,
                    utc: GpsUtc | None = None,
                    almanac: GpsAlmanac | None = None
                    ) -> tuple[np.ndarray, int, int]:
    """Encode one 300-bit subframe; returns (bits, D29*, D30*) for chaining."""
    words = _subframe_data_words(sf_id, eph, tow_next_s, iono, utc, almanac)
    out = np.zeros(300, dtype=np.int64)
    for w in range(10):
        solve = w in (1, 9)
        tx = encode_word(words[w], d29s, d30s, solve_tail=solve)
        out[w * 30 : (w + 1) * 30] = tx
        d29s, d30s = int(tx[28]), int(tx[29])
    return out, d29s, d30s


def encode_lnav_frame(eph: GpsEphemeris, tow_first_s: float,
                      n_subframes: int = 5,
                      subframe_cycle: tuple[int, ...] = (1, 2, 3, 4, 5),
                      iono: GpsIono | None = None,
                      utc: GpsUtc | None = None,
                      almanacs: list[GpsAlmanac] | None = None) -> np.ndarray:
    """Encode consecutive subframes cycling through `subframe_cycle`,
    starting at TOW `tow_first_s` (start of the first subframe).  Returns a
    0/1 bit array of length 300*n_subframes.  (Tests use cycle (1,2,3) to
    shorten time-to-complete-ephemeris.)  When iono+utc are given, every
    subframe 4 carries page 18; `almanacs` pages cycle through subframe 5
    occurrences (and subframe 4 when no iono/utc page occupies it)."""
    bits = []
    d29s = d30s = 0
    alm_k = 0
    for k in range(n_subframes):
        sf_id = subframe_cycle[k % len(subframe_cycle)]
        tow_next = tow_first_s + (k + 1) * 6.0
        alm = None
        if almanacs and (sf_id == 5
                         or (sf_id == 4 and iono is None and utc is None)):
            alm = almanacs[alm_k % len(almanacs)]
            alm_k += 1
        sf, d29s, d30s = encode_subframe(sf_id, eph, tow_next, d29s, d30s,
                                         iono, utc, alm)
        bits.append(sf)
    return np.concatenate(bits)


def decode_subframe(bits300: np.ndarray, d29s: int, d30s: int,
                    eph: GpsEphemeris,
                    iono: GpsIono | None = None,
                    utc: GpsUtc | None = None,
                    almanacs: dict[int, GpsAlmanac] | None = None
                    ) -> tuple[int, float] | None:
    """Decode one 300-bit subframe into `eph` (in place); subframe 4/5
    almanac pages land in `almanacs` keyed by SV id.

    Returns (subframe_id, tow_next_s) on success or None on parity failure.
    Mirrors Gps_Navigation_Message::subframe_decoder
    (gps_navigation_message.cc:200+ incl. the :651-area almanac pages).
    """
    bits = np.asarray(bits300, dtype=np.int64)
    data = np.zeros((10, 24), dtype=np.int64)
    for w in range(10):
        word = bits[w * 30 : (w + 1) * 30]
        if not parity_check(word, d29s, d30s):
            return None
        data[w] = word[:24] ^ d30s
        d29s, d30s = int(word[28]), int(word[29])

    how = data[1]
    tow17 = _unpack(how, [17])[0]
    sf_id = _unpack(how[19:22], [3])[0]
    tow_next_s = tow17 * 6.0

    if sf_id == 1:
        wn, _l2, _ura, health, iodc_hi = _unpack(data[2], [10, 2, 4, 6, 2])
        _res, tgd = _unpack(data[6], [16, 8])
        iodc_lo, toc = _unpack(data[7], [8, 16])
        af2, af1 = _unpack(data[8], [8, 16])
        af0, _t = _unpack(data[9], [22, 2])
        eph.week = wn
        eph.sv_health = health
        eph.iodc = (iodc_hi << 8) | iodc_lo
        eph.tgd = _sbits(tgd, 8) * 2.0**-31
        eph.toc = toc * 2.0**4
        eph.af2 = _sbits(af2, 8) * 2.0**-55
        eph.af1 = _sbits(af1, 16) * 2.0**-43
        eph.af0 = _sbits(af0, 22) * 2.0**-31
    elif sf_id == 2:
        iode, crs = _unpack(data[2], [8, 16])
        dn, m0_hi = _unpack(data[3], [16, 8])
        (m0_lo,) = _unpack(data[4], [24])
        cuc, e_hi = _unpack(data[5], [16, 8])
        (e_lo,) = _unpack(data[6], [24])
        cus, sqa_hi = _unpack(data[7], [16, 8])
        (sqa_lo,) = _unpack(data[8], [24])
        toe, _fit, _aodo, _t = _unpack(data[9], [16, 1, 5, 2])
        eph.iode = iode
        eph.crs = _sbits(crs, 16) * 2.0**-5
        eph.delta_n = _sbits(dn, 16) * 2.0**-43
        eph.m0 = _sbits((m0_hi << 24) | m0_lo, 32) * 2.0**-31
        eph.cuc = _sbits(cuc, 16) * 2.0**-29
        eph.e = ((e_hi << 24) | e_lo) * 2.0**-33
        eph.cus = _sbits(cus, 16) * 2.0**-29
        eph.sqrt_a = ((sqa_hi << 24) | sqa_lo) * 2.0**-19
        eph.toe = toe * 2.0**4
    elif sf_id == 3:
        cic, om0_hi = _unpack(data[2], [16, 8])
        (om0_lo,) = _unpack(data[3], [24])
        cis, i0_hi = _unpack(data[4], [16, 8])
        (i0_lo,) = _unpack(data[5], [24])
        crc, om_hi = _unpack(data[6], [16, 8])
        (om_lo,) = _unpack(data[7], [24])
        (omdot,) = _unpack(data[8], [24])
        iode3, idot, _t = _unpack(data[9], [8, 14, 2])
        eph.cic = _sbits(cic, 16) * 2.0**-29
        eph.omega0 = _sbits((om0_hi << 24) | om0_lo, 32) * 2.0**-31
        eph.cis = _sbits(cis, 16) * 2.0**-29
        eph.i0 = _sbits((i0_hi << 24) | i0_lo, 32) * 2.0**-31
        eph.crc = _sbits(crc, 16) * 2.0**-5
        eph.omega = _sbits((om_hi << 24) | om_lo, 32) * 2.0**-31
        eph.omega_dot = _sbits(omdot, 24) * 2.0**-43
        eph.iode = iode3
        eph.idot = _sbits(idot, 14) * 2.0**-43
    elif sf_id in (4, 5):
        _did, svid = _unpack(data[2][:8], [2, 6])
        if 1 <= svid <= 32 and almanacs is not None:
            _d, _s, e_raw = _unpack(data[2], [2, 6, 16])
            toa_raw, di = _unpack(data[3], [8, 16])
            omdot, health = _unpack(data[4], [16, 8])
            (sqa,) = _unpack(data[5], [24])
            (om0,) = _unpack(data[6], [24])
            (om,) = _unpack(data[7], [24])
            (m0,) = _unpack(data[8], [24])
            af0_hi, af1, af0_lo, _t = _unpack(data[9], [8, 11, 3, 2])
            almanacs[svid] = GpsAlmanac(
                prn=svid,
                e=e_raw * 2.0**-21,
                toa=toa_raw * 2.0**12,
                delta_i=_sbits(di, 16) * 2.0**-19,
                omega_dot=_sbits(omdot, 16) * 2.0**-38,
                sv_health=health,
                sqrt_a=sqa * 2.0**-11,
                omega0=_sbits(om0, 24) * 2.0**-23,
                omega=_sbits(om, 24) * 2.0**-23,
                m0=_sbits(m0, 24) * 2.0**-23,
                af0=_sbits((af0_hi << 3) | af0_lo, 11) * 2.0**-20,
                af1=_sbits(af1, 11) * 2.0**-38,
            )
        elif svid == 56 and sf_id == 4:  # page 18: iono + UTC
            if iono is not None:
                _d, _s, a0i, a1i = _unpack(data[2], [2, 6, 8, 8])
                a2i, a3i, b0 = _unpack(data[3], [8, 8, 8])
                b1, b2, b3 = _unpack(data[4], [8, 8, 8])
                iono.alpha0 = _sbits(a0i, 8) * 2.0**-30
                iono.alpha1 = _sbits(a1i, 8) * 2.0**-27
                iono.alpha2 = _sbits(a2i, 8) * 2.0**-24
                iono.alpha3 = _sbits(a3i, 8) * 2.0**-24
                iono.beta0 = _sbits(b0, 8) * 2.0**11
                iono.beta1 = _sbits(b1, 8) * 2.0**14
                iono.beta2 = _sbits(b2, 8) * 2.0**16
                iono.beta3 = _sbits(b3, 8) * 2.0**16
                iono.valid = True
            if utc is not None:
                (a1u,) = _unpack(data[5], [24])
                (a0_hi,) = _unpack(data[6], [24])
                a0_lo, tot, wnt = _unpack(data[7], [8, 8, 8])
                dtls, wnlsf, dn = _unpack(data[8], [8, 8, 8])
                dtlsf, _r, _t = _unpack(data[9], [8, 14, 2])
                utc.a1 = _sbits(a1u, 24) * 2.0**-50
                utc.a0 = _sbits((a0_hi << 8) | a0_lo, 32) * 2.0**-30
                utc.tot = tot * 2.0**12
                utc.wn_t = wnt
                utc.delta_t_ls = _sbits(dtls, 8)
                utc.wn_lsf = wnlsf
                utc.dn = dn
                utc.delta_t_lsf = _sbits(dtlsf, 8)
                utc.valid = True
    return sf_id, tow_next_s
