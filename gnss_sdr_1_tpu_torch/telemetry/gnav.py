"""GLONASS L1/L2 C/A GNAV message layer (GLONASS ICD 5.1).

Reference parity: glonass_l{1,2}_ca_telemetry_decoder_gs.cc (meander
stripping, time-mark correlation) + glonass_gnav_navigation_message.cc
(string decode, Hamming check with the ICD index sets, ephemeris fields).

Representation: a string is 85 bits; we store `b[n-1]` = ICD bit number n
(bit 85 is transmitted first).  Field positions use the reference's
(position-from-transmit-start, width) convention (GLONASS_L1_L2_CA.h:258+).
Signed quantities are SIGN-MAGNITUDE per the ICD.  Satellite position uses
the broadcast ECEF state vector + RK4 integration (pvt.glonass_orbits).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Hamming check index sets (ICD table; GLONASS_L1_L2_CA.h:251-257)
_IDX = {
    1: (9, 10, 12, 13, 15, 17, 19, 20, 22, 24, 26, 28, 30, 32, 34, 35, 37,
        39, 41, 43, 45, 47, 49, 51, 53, 55, 57, 59, 61, 63, 65, 66, 68, 70,
        72, 74, 76, 78, 80, 82, 84),
    2: (9, 11, 12, 14, 15, 18, 19, 21, 22, 25, 26, 29, 30, 33, 34, 36, 37,
        40, 41, 44, 45, 48, 49, 52, 53, 56, 57, 60, 61, 64, 65, 67, 68, 71,
        72, 75, 76, 79, 80, 83, 84),
    3: (10, 11, 12, 16, 17, 18, 19, 23, 24, 25, 26, 31, 32, 33, 34, 38, 39,
        40, 41, 46, 47, 48, 49, 54, 55, 56, 57, 62, 63, 64, 65, 69, 70, 71,
        72, 77, 78, 79, 80, 85),
    4: (13, 14, 15, 16, 17, 18, 19, 27, 28, 29, 30, 31, 32, 33, 34, 42, 43,
        44, 45, 46, 47, 48, 49, 58, 59, 60, 61, 62, 63, 64, 65, 73, 74, 75,
        76, 77, 78, 79, 80),
    5: (20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 50, 51,
        52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 81, 82, 83,
        84, 85),
    6: tuple(range(35, 66)),
    7: tuple(range(66, 86)),
}
_Q_IDX = tuple(range(9, 86))

# time mark: 30-symbol shortened PR sequence ending each string (ICD 3.3.1.2)
TIME_MARK = np.array([1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1,
                      0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0], dtype=np.int64)

STRING_BITS = 85


@dataclasses.dataclass
class GlonassEphemeris:
    """Broadcast state vector (Glonass_Gnav_Ephemeris analogue)."""

    slot: int = 0
    freq_channel: int = 0
    tb_s: float = 0.0        # ephemeris reference, seconds into the day
    tk_s: float = 0.0        # frame time
    x_km: float = 0.0
    y_km: float = 0.0
    z_km: float = 0.0
    vx_kms: float = 0.0
    vy_kms: float = 0.0
    vz_kms: float = 0.0
    ax_kms2: float = 0.0     # luni-solar acceleration
    ay_kms2: float = 0.0
    az_kms2: float = 0.0
    gamma_n: float = 0.0     # relative freq deviation
    tau_n_s: float = 0.0     # clock offset
    health_bn: int = 0
    nt_days: int = 0


def _parity(bits, idxs) -> int:
    return int(sum(int(bits[i - 1]) for i in idxs) & 1)


def hamming_check(b: np.ndarray) -> bool:
    """ICD checksum conditions (CRC_test parity,
    glonass_gnav_navigation_message.cc:112)."""
    c = [int(b[k - 1]) ^ _parity(b, _IDX[k]) for k in range(1, 8)]
    data_sum = sum(int(b[i - 1]) for i in _Q_IDX) & 1
    ham_sum = sum(int(b[i - 1]) for i in range(1, 9)) & 1
    c_sigma = data_sum ^ ham_sum
    if sum(c) + c_sigma == 0:
        return True
    if c_sigma == 1 and sum(c) == 6:
        return True
    return False


def hamming_encode(b: np.ndarray) -> np.ndarray:
    """Solve check bits 1-8 so all checksums are zero (data bits 9-85 set)."""
    b = b.copy()
    b[0:8] = 0
    for k in range(1, 8):
        b[k - 1] = _parity(b, _IDX[k])
    data_sum = sum(int(b[i - 1]) for i in _Q_IDX) & 1
    ham7 = sum(int(b[i - 1]) for i in range(1, 8)) & 1
    # beta8 makes C_Sigma = 0: data_sum ^ (ham7 + beta8) = 0
    b[7] = data_sum ^ ham7
    return b


def _put(b: np.ndarray, pos: int, width: int, value: int) -> None:
    """Reference (position, width): MSB at ICD bit 86-pos."""
    v = int(value) & ((1 << width) - 1)
    msb_bit = 86 - pos
    for k in range(width):
        b[msb_bit - 1 - k] = (v >> (width - 1 - k)) & 1


def _get(b: np.ndarray, pos: int, width: int) -> int:
    msb_bit = 86 - pos
    v = 0
    for k in range(width):
        v = (v << 1) | int(b[msb_bit - 1 - k])
    return v


def _sm_encode(value: float, scale: float, width: int) -> int:
    """Sign-magnitude quantization (MSB = sign)."""
    q = int(round(abs(value) / (2.0 ** scale)))
    q = min(q, (1 << (width - 1)) - 1)
    return ((1 << (width - 1)) | q) if value < 0 else q


def _sm_decode(v: int, scale: float, width: int) -> float:
    sign = -1.0 if v & (1 << (width - 1)) else 1.0
    return sign * (v & ((1 << (width - 1)) - 1)) * (2.0 ** scale)


def encode_string(string_id: int, eph: GlonassEphemeris) -> np.ndarray:
    """One 85-bit GNAV string (ICD bit array, b[n-1] = bit n)."""
    b = np.zeros(STRING_BITS, dtype=np.int64)
    _put(b, 2, 4, string_id)
    if string_id == 1:
        hrs = int(eph.tk_s // 3600)
        mins = int((eph.tk_s % 3600) // 60)
        sec30 = int((eph.tk_s % 60) // 30)
        _put(b, 10, 5, hrs)
        _put(b, 15, 6, mins)
        _put(b, 21, 1, sec30)
        _put(b, 22, 24, _sm_encode(eph.vx_kms, -20, 24))
        _put(b, 46, 5, _sm_encode(eph.ax_kms2, -30, 5))
        _put(b, 51, 27, _sm_encode(eph.x_km, -11, 27))
    elif string_id == 2:
        _put(b, 6, 3, eph.health_bn)
        _put(b, 10, 7, int(eph.tb_s / 900.0))
        _put(b, 22, 24, _sm_encode(eph.vy_kms, -20, 24))
        _put(b, 46, 5, _sm_encode(eph.ay_kms2, -30, 5))
        _put(b, 51, 27, _sm_encode(eph.y_km, -11, 27))
    elif string_id == 3:
        _put(b, 7, 11, _sm_encode(eph.gamma_n, -40, 11))
        _put(b, 22, 24, _sm_encode(eph.vz_kms, -20, 24))
        _put(b, 46, 5, _sm_encode(eph.az_kms2, -30, 5))
        _put(b, 51, 27, _sm_encode(eph.z_km, -11, 27))
    elif string_id == 4:
        _put(b, 6, 22, _sm_encode(eph.tau_n_s, -30, 22))
        _put(b, 60, 11, eph.nt_days)
        _put(b, 71, 5, eph.slot)
    return hamming_encode(b)


def decode_string(b: np.ndarray, eph: GlonassEphemeris) -> int | None:
    """Parse one 85-bit string into `eph`; returns string id or None on a
    failed Hamming check."""
    if not hamming_check(b):
        return None
    sid = _get(b, 2, 4)
    if sid == 1:
        eph.tk_s = (_get(b, 10, 5) * 3600 + _get(b, 15, 6) * 60
                    + _get(b, 21, 1) * 30)
        eph.vx_kms = _sm_decode(_get(b, 22, 24), -20, 24)
        eph.ax_kms2 = _sm_decode(_get(b, 46, 5), -30, 5)
        eph.x_km = _sm_decode(_get(b, 51, 27), -11, 27)
    elif sid == 2:
        eph.health_bn = _get(b, 6, 3)
        eph.tb_s = _get(b, 10, 7) * 900.0
        eph.vy_kms = _sm_decode(_get(b, 22, 24), -20, 24)
        eph.ay_kms2 = _sm_decode(_get(b, 46, 5), -30, 5)
        eph.y_km = _sm_decode(_get(b, 51, 27), -11, 27)
    elif sid == 3:
        eph.gamma_n = _sm_decode(_get(b, 7, 11), -40, 11)
        eph.vz_kms = _sm_decode(_get(b, 22, 24), -20, 24)
        eph.az_kms2 = _sm_decode(_get(b, 46, 5), -30, 5)
        eph.z_km = _sm_decode(_get(b, 51, 27), -11, 27)
    elif sid == 4:
        eph.tau_n_s = _sm_decode(_get(b, 6, 22), -30, 22)
        eph.nt_days = _get(b, 60, 11)
        eph.slot = _get(b, 71, 5)
    return sid


# ---------------- symbol layer ----------------

def string_to_symbols(b: np.ndarray) -> np.ndarray:
    """One 2-second string -> 200 symbols at 100 sps:
    85 data bits XOR the 100 Hz meander (each 10 ms half-bit flips), bit 85
    first, then the 30-symbol time mark at 10 ms each (0.3 s).
    Returns 0/1 symbols (1 -> -1 amplitude downstream)."""
    tx_bits = b[::-1]                     # bit 85 first
    data_syms = np.empty(170, dtype=np.int64)
    data_syms[0::2] = tx_bits ^ 0         # meander 0 half
    data_syms[1::2] = tx_bits ^ 1         # meander 1 half
    return np.concatenate([data_syms, TIME_MARK])


def symbols_to_string(syms200: np.ndarray) -> np.ndarray | None:
    """Inverse of string_to_symbols; returns None if the meander structure
    is violated (both halves equal)."""
    d0 = syms200[0:170:2]
    d1 = syms200[1:170:2]
    if np.any(d0 == d1):
        return None
    return np.asarray(d0[::-1], dtype=np.int64)


class GnavDecoder:
    """Per-channel GNAV decoder: one prompt per 10 ms (meander half-bit).

    Tracking at 1 ms epochs feeds 10-epoch sums (the channel wrapper does
    the 10:1 aggregation); time-mark correlation gives string sync; strings
    1-4 complete the ephemeris.
    """

    def __init__(self, slot: int = 0):
        self.slot = slot
        self._soft: list[float] = []
        self.ephemeris = GlonassEphemeris(slot=slot)
        self.aux = GnavAux()          # UTC (string 5) + almanac (6-15)
        self.strings: set[int] = set()
        self.string_sync = False
        self._sync_offset: int | None = None
        self._polarity = 1.0
        self._decoded_until = 0
        self._tow_symbol: int | None = None
        self._tod_s: float | None = None     # time of day (MT boundary)

    @property
    def ephemeris_complete(self) -> bool:
        return {1, 2, 3}.issubset(self.strings)

    def push(self, prompt_i) -> None:
        self._soft.extend(np.asarray(prompt_i, dtype=np.float64))
        if not self.string_sync:
            self._find_sync()
        if self.string_sync:
            self._decode()

    def tod_at_symbol(self, symbol_idx: int) -> float | None:
        """GLONASS time-of-day at a 10 ms symbol index (from tk)."""
        if self._tod_s is None:
            return None
        return self._tod_s + 0.01 * (symbol_idx - self._tow_symbol)

    def _find_sync(self) -> None:
        s = np.sign(np.asarray(self._soft))
        if len(s) < 430:
            return
        pat = 1.0 - 2.0 * TIME_MARK
        for pol in (1.0, -1.0):
            c = np.correlate(pol * s, pat, mode="valid")
            hits = np.nonzero(c == 30.0)[0]
            for h in hits:
                later = hits[(hits > h) & ((hits - h) % 200 == 0)]
                if len(later) >= 1:
                    # string DATA starts right after the time mark
                    self.string_sync = True
                    self._sync_offset = int(h) + 30
                    self._polarity = pol
                    self._decoded_until = self._sync_offset
                    return

    def _decode(self) -> None:
        soft = np.asarray(self._soft)
        while len(soft) >= self._decoded_until + 200:
            seg = soft[self._decoded_until : self._decoded_until + 200]
            syms = ((self._polarity * seg) < 0).astype(np.int64)
            if not np.array_equal(syms[170:], TIME_MARK):
                self.string_sync = False
                self._find_sync()
                if not self.string_sync:
                    return
                continue
            bits = symbols_to_string(syms)
            if bits is not None:
                sid = decode_string(bits, self.ephemeris)
                if sid is not None and sid >= 5:
                    decode_string_aux(bits, self.aux)
                if sid is not None:
                    self.strings.add(sid)
                    if sid == 1:
                        # tk marks the start of this frame's first string;
                        # anchor time-of-day at this string's data start
                        self._tow_symbol = self._decoded_until
                        self._tod_s = self.ephemeris.tk_s
            self._decoded_until += 200


# ----------------------------------------------------------------------
# String 5 (UTC/time-scale) + almanac string pairs 6/8/10/12/14 (even) and
# 7/9/11/13/15 (odd) — glonass_gnav_navigation_message.cc :407-501, bit
# tables GLONASS_L1_L2_CA.h:304-324.  The reference reads these fields as
# two's complement (read_navigation_signed); angles are stored in radians
# (the reference multiplies the semicircle LSBs by GLONASS_PI).
# ----------------------------------------------------------------------

_GLO_PI = 3.1415926535898


def _tc_encode(value: float, scale: float, width: int) -> int:
    return int(round(value / (2.0 ** scale))) & ((1 << width) - 1)


def _tc_decode(v: int, scale: float, width: int) -> float:
    if v & (1 << (width - 1)):
        v -= 1 << width
    return v * (2.0 ** scale)


@dataclasses.dataclass
class GlonassUtc:
    """GLONASS time-scale corrections (Glonass_Gnav_Utc_Model,
    glonass_gnav_utc_model.h): string 5."""

    n_a: int = 0               # calendar day number within 4-year period
    tau_c: float = 0.0         # GLONASS->UTC(SU) [s]
    n_4: int = 0               # 4-year interval number
    tau_gps: float = 0.0       # GPS-GLONASS time offset [s]
    valid: bool = False


@dataclasses.dataclass
class GlonassAlmanac:
    """Per-slot GNAV almanac (Glonass_Gnav_Almanac,
    glonass_gnav_almanac.h): one even/odd string pair."""

    slot: int = 0              # n_A
    c_n: int = 0               # health flag
    m_n: int = 0               # satellite type
    tau_n: float = 0.0         # coarse clock [s]
    lambda_n: float = 0.0      # longitude of ascending node [rad]
    delta_i_n: float = 0.0     # inclination correction vs 63 deg [rad]
    epsilon_n: float = 0.0     # eccentricity
    omega_n: float = 0.0       # argument of perigee [rad]
    t_lambda_n: float = 0.0    # time of ascending node crossing [s]
    delta_t_n: float = 0.0     # draconic period correction [s/orbit]
    delta_t_dot_n: float = 0.0
    h_n: int = 0               # frequency channel code (k+32 for k<0)
    l_n: int = 0

    @property
    def freq_channel_k(self) -> int:
        """H_n code -> FDMA k (reference :489-492)."""
        return self.h_n - 32 if self.h_n > 24 else self.h_n


@dataclasses.dataclass
class GnavAux:
    utc: GlonassUtc = dataclasses.field(default_factory=GlonassUtc)
    almanacs: dict = dataclasses.field(default_factory=dict)
    _stage: dict = dataclasses.field(default_factory=dict)


def encode_string_aux(string_id: int, aux: GnavAux,
                      alm: "GlonassAlmanac | None" = None) -> np.ndarray:
    """Encode string 5 (UTC) or an almanac even/odd string (6-15)."""
    b = np.zeros(STRING_BITS, dtype=np.int64)
    _put(b, 2, 4, string_id)
    if string_id == 5:
        u = aux.utc
        _put(b, 6, 11, u.n_a)
        _put(b, 17, 32, _tc_encode(u.tau_c, -31, 32))
        _put(b, 50, 5, u.n_4)
        _put(b, 55, 22, _tc_encode(u.tau_gps, -30, 22))
    elif string_id in (6, 8, 10, 12, 14):
        a = alm
        _put(b, 6, 1, a.c_n)
        _put(b, 7, 2, a.m_n)
        _put(b, 9, 5, a.slot)
        _put(b, 14, 10, int(round(a.tau_n / 2.0 ** -18)))
        _put(b, 24, 21, _tc_encode(a.lambda_n / _GLO_PI, -20, 21))
        _put(b, 45, 18, _tc_encode(a.delta_i_n / _GLO_PI, -20, 18))
        _put(b, 63, 15, int(round(a.epsilon_n / 2.0 ** -20)))
    elif string_id in (7, 9, 11, 13, 15):
        a = alm
        _put(b, 6, 16, _tc_encode(a.omega_n / _GLO_PI, -15, 16))
        _put(b, 22, 21, int(round(a.t_lambda_n / 2.0 ** -5)))
        _put(b, 43, 22, _tc_encode(a.delta_t_n, -9, 22))
        _put(b, 65, 7, _tc_encode(a.delta_t_dot_n, -14, 7))
        _put(b, 72, 5, a.h_n)
        _put(b, 77, 1, a.l_n)
    return hamming_encode(b)


def decode_string_aux(b: np.ndarray, aux: GnavAux) -> int | None:
    """Parse string 5 / almanac strings into `aux` (Hamming-checked);
    returns the string id or None.  Almanac pairs join when the odd string
    follows its even one (flag_almanac_str_N staging, :479)."""
    if not hamming_check(b):
        return None
    sid = _get(b, 2, 4)
    if sid == 5:
        aux.utc = GlonassUtc(
            n_a=_get(b, 6, 11),
            tau_c=_tc_decode(_get(b, 17, 32), -31, 32),
            n_4=_get(b, 50, 5),
            tau_gps=_tc_decode(_get(b, 55, 22), -30, 22),
            valid=True)
    elif sid in (6, 8, 10, 12, 14):
        aux._stage["even"] = {
            "sid": sid,
            "c_n": _get(b, 6, 1), "m_n": _get(b, 7, 2),
            "slot": _get(b, 9, 5),
            "tau_n": _get(b, 14, 10) * 2.0 ** -18,
            "lambda_n": _tc_decode(_get(b, 24, 21), -20, 21) * _GLO_PI,
            "delta_i_n": _tc_decode(_get(b, 45, 18), -20, 18) * _GLO_PI,
            "epsilon_n": _get(b, 63, 15) * 2.0 ** -20}
    elif sid in (7, 9, 11, 13, 15):
        ev = aux._stage.pop("even", None)
        if ev is not None and ev.pop("sid") == sid - 1 and ev["slot"]:
            aux.almanacs[ev["slot"]] = GlonassAlmanac(
                omega_n=_tc_decode(_get(b, 6, 16), -15, 16) * _GLO_PI,
                t_lambda_n=_get(b, 22, 21) * 2.0 ** -5,
                delta_t_n=_tc_decode(_get(b, 43, 22), -9, 22),
                delta_t_dot_n=_tc_decode(_get(b, 65, 7), -14, 7),
                h_n=_get(b, 72, 5),
                l_n=_get(b, 77, 1), **ev)
    return sid
