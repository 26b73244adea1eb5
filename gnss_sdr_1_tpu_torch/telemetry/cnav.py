"""GPS CNAV (L2C / L5) message layer: FEC framing, CRC, TOW (IS-GPS-200/705).

Reference parity: gps_l2c_telemetry_decoder_gs.cc / gps_l5_telemetry_decoder
_gs.cc + libswiftcnav cnav_msg.c: symbols are rate-1/2 K=7 convolutionally
encoded; the decoder runs soft-decision Viterbi (utils.native), then hunts
for 300-bit messages [preamble(8) prn(6) type(6) tow(17) alert(1)
payload(238) crc24q(24)] in both polarities and both symbol phases.

Message types 10/11 (ephemeris) and the 30-group clock block are parsed
into CnavEphemeris (IS-GPS-200 30.3.3.1-3; the reference extracts the same
fields in libswiftcnav cnav_msg.c + gps_cnav_navigation_message.cc), with
`to_keplerian()` feeding the common pvt.ephemeris orbit model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.native import crc24q, viterbi27
from .inav import _get, _put, _q

CNAV_PREAMBLE = np.array([1, 0, 0, 0, 1, 0, 1, 1], dtype=np.int64)
CNAV_MSG_BITS = 300

A_REF_M = 26_559_710.0          # CNAV semi-major axis reference (30.3.3.1.1)
OMEGA_DOT_REF_SC = -2.6e-9      # semicircles/s


@dataclasses.dataclass
class CnavEphemeris:
    """CNAV ephemeris+clock (MT10 + MT11 + MT3x clock block); the subset of
    Gps_CNAV_Ephemeris (src/core/system_parameters/gps_cnav_ephemeris.h)
    the orbit/clock models need."""

    prn: int = 0
    wn: int = 0
    top: float = 0.0
    toe: float = 0.0
    delta_a: float = 0.0        # m, vs A_REF_M
    a_dot: float = 0.0          # m/s
    delta_n0: float = 0.0       # semicircles/s
    delta_n0_dot: float = 0.0   # semicircles/s^2
    m0: float = 0.0             # semicircles
    e: float = 0.0
    omega: float = 0.0          # semicircles
    omega0: float = 0.0
    i0: float = 0.0
    delta_omega_dot: float = 0.0   # vs OMEGA_DOT_REF_SC
    i0_dot: float = 0.0
    cis: float = 0.0
    cic: float = 0.0
    crs: float = 0.0
    crc: float = 0.0
    cus: float = 0.0
    cuc: float = 0.0
    # clock (MT30-37 shared block)
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    isc_l2c: float = 0.0
    isc_l5i: float = 0.0
    have: set = dataclasses.field(default_factory=set)

    @property
    def complete(self) -> bool:
        return {10, 11, 30}.issubset(self.have)

    def to_keplerian(self):
        """-> the GPS-style Keplerian record used by pvt.ephemeris,
        evaluated with the CNAV reference offsets folded in (A_REF/
        OMEGA_DOT_REF; Adot/Δn0dot second-order terms are << 1 m over a
        fit interval and are dropped, as rtklib eph2pos does)."""
        from .lnav import GpsEphemeris

        return GpsEphemeris(
            prn=self.prn, week=self.wn,
            toc=self.toc, toe=self.toe,
            af0=self.af0, af1=self.af1, af2=self.af2, tgd=self.tgd,
            iodc=0, iode=0,
            sqrt_a=float(np.sqrt(A_REF_M + self.delta_a)),
            e=self.e, m0=self.m0,
            delta_n=self.delta_n0,
            omega0=self.omega0, i0=self.i0, omega=self.omega,
            omega_dot=OMEGA_DOT_REF_SC + self.delta_omega_dot,
            idot=self.i0_dot,
            cuc=self.cuc, cus=self.cus, crc=self.crc, crs=self.crs,
            cic=self.cic, cis=self.cis,
        )


def _bits_to_bytes(bits: np.ndarray) -> bytes:
    pad = (-len(bits)) % 8
    b = np.concatenate([bits, np.zeros(pad, dtype=bits.dtype)])
    return np.packbits(b.astype(np.uint8)).tobytes()


def crc_check(msg300: np.ndarray) -> bool:
    """CRC-24Q over the first 276 bits must equal the last 24."""
    data = msg300[:276]
    want = 0
    for b in msg300[276:]:
        want = (want << 1) | int(b)
    return crc24q(_bits_to_bytes(data)) == want


# Field layouts: (attr, bit offset in the 300-bit message, width, signed,
# scale exponent or None for raw ints / special handling).
_MT10_FIELDS = (
    ("wn", 38, 13, False, None),
    ("top", 54, 11, False, 300.0),
    ("toe", 70, 11, False, 300.0),
    ("delta_a", 81, 26, True, -9),
    ("a_dot", 107, 25, True, -21),
    ("delta_n0", 132, 17, True, -44),
    ("delta_n0_dot", 149, 23, True, -57),
    ("m0", 172, 33, True, -32),
    ("e", 205, 33, False, -34),
    ("omega", 238, 33, True, -32),
)
_MT11_FIELDS = (
    ("toe", 38, 11, False, 300.0),
    ("omega0", 49, 33, True, -32),
    ("i0", 82, 33, True, -32),
    ("delta_omega_dot", 115, 17, True, -44),
    ("i0_dot", 132, 15, True, -44),
    ("cis", 147, 16, True, -30),
    ("cic", 163, 16, True, -30),
    ("crs", 179, 24, True, -8),
    ("crc", 203, 24, True, -8),
    ("cus", 227, 21, True, -30),
    ("cuc", 248, 21, True, -30),
)
_MT30_FIELDS = (
    ("top", 38, 11, False, 300.0),
    ("toc", 60, 11, False, 300.0),
    ("af0", 71, 26, True, -35),
    ("af1", 97, 20, True, -48),
    ("af2", 117, 10, True, -60),
    ("tgd", 127, 13, True, -35),
    ("isc_l2c", 153, 13, True, -35),
    ("isc_l5i", 166, 13, True, -35),
)
_MT30_IONO = (  # (attr on GpsIono, offset, scale exponent)
    ("alpha0", 192, -30), ("alpha1", 200, -27),
    ("alpha2", 208, -24), ("alpha3", 216, -24),
    ("beta0", 224, 11), ("beta1", 232, 14),
    ("beta2", 240, 16), ("beta3", 248, 16),
)
_FIELDS_BY_MT = {10: _MT10_FIELDS, 11: _MT11_FIELDS, 30: _MT30_FIELDS}


def _encode_fields(b: np.ndarray, fields, src) -> None:
    for attr, off, width, _signed, scale in fields:
        v = getattr(src, attr)
        if scale is None:
            q = int(v)
        elif isinstance(scale, float):
            q = int(round(v / scale))
        else:
            q = _q(v, scale)
        _put(b, off, width, q)


def _decode_fields(b: np.ndarray, fields, dst) -> None:
    for attr, off, width, signed, scale in fields:
        raw = _get(b, off, width, signed=signed)
        if scale is None:
            setattr(dst, attr, raw)
        elif isinstance(scale, float):
            setattr(dst, attr, raw * scale)
        else:
            setattr(dst, attr, raw * 2.0**scale)


def encode_message(mt: int, eph: CnavEphemeris, tow_next_s: float,
                   iono=None) -> np.ndarray:
    """Build one 300-bit CNAV message (types 10/11/30) with valid CRC —
    the test/siggen fixture the reference gets from recorded captures."""
    b = np.zeros(CNAV_MSG_BITS, dtype=np.int64)
    b[:8] = CNAV_PREAMBLE
    _put(b, 8, 6, eph.prn)
    _put(b, 14, 6, mt)
    _put(b, 20, 17, int(round(tow_next_s / 6.0)))
    _encode_fields(b, _FIELDS_BY_MT[mt], eph)
    if mt == 30 and iono is not None:
        for attr, off, scale in _MT30_IONO:
            _put(b, off, 8, _q(getattr(iono, attr), scale))
    crc = crc24q(_bits_to_bytes(b[:276]))
    _put(b, 276, 24, crc)
    return b


class CnavMessage:
    def __init__(self, bits300: np.ndarray):
        b = bits300

        def u(lo, hi):
            v = 0
            for x in b[lo:hi]:
                v = (v << 1) | int(x)
            return v

        self.prn = u(8, 14)
        self.msg_type = u(14, 20)
        self.tow_next_s = u(20, 37) * 6.0
        self.alert = u(37, 38)
        self.payload = np.array(b[38:276], dtype=np.int64)


class CnavDecoder:
    """Per-channel CNAV stream decoder.

    Feed one soft symbol per tracking epoch (L2CM: 20 ms epochs = 50 sps).
    The Viterbi runs over the accumulated stream; messages are hunted at
    every 300-bit offset by preamble + CRC.
    """

    def __init__(self, prn: int = 0):
        self.prn = prn
        self._soft: list[int] = []
        self.messages: list[CnavMessage] = []
        self.ephemeris = CnavEphemeris(prn=prn)
        from .lnav import GpsIono

        self.iono = GpsIono()
        self.frame_sync = False
        self._sym_offset: int | None = None  # symbol index of first message
        self._tow_symbol: int | None = None
        self._tow_s: float | None = None
        self._decoded_until = 0

    @property
    def ephemeris_complete(self) -> bool:
        return self.ephemeris.complete

    def push(self, prompt_i: np.ndarray, start_samples=None) -> None:
        """prompt_i: correlator outputs, one per symbol (sign = symbol)."""
        p = np.asarray(prompt_i, dtype=np.float64)
        scale = np.median(np.abs(p)) or 1.0
        soft = np.clip(128 + 127 * (p / (3 * scale)), 0, 255).astype(np.uint8)
        self._soft.extend(soft)
        self._process()

    # symbol period: 20 ms on L2CM (50 sps), 10 ms on L5I (100 sps)
    symbol_period_s: float = 0.02

    def tow_at_symbol(self, symbol_idx: int) -> float | None:
        if self._tow_s is None:
            return None
        return self._tow_s + self.symbol_period_s * (
            symbol_idx - self._tow_symbol)

    def _process(self) -> None:
        n = len(self._soft)
        # re-decode cadence: 150 symbols (not a full 600-symbol message —
        # that left the stream TAIL unprocessed in segment-cadence feeds,
        # silently dropping the last message type; round-5 L5 diagnosis)
        if n < 2 * CNAV_MSG_BITS + 64 or n - self._decoded_until < 150:
            return
        soft = np.asarray(self._soft, dtype=np.uint8)
        for phase in (0, 1):
            for pol in (1, -1):
                s = soft[phase:]
                s = s[: (len(s) // 2) * 2]
                if pol < 0:
                    s = 255 - s
                bits, _ = viterbi27(s)
                if self._hunt(bits, phase):
                    self._decoded_until = n
                    return
        self._decoded_until = n

    def _hunt(self, bits: np.ndarray, phase: int) -> bool:
        found = False
        i = 0
        while i + CNAV_MSG_BITS <= len(bits):
            w = bits[i : i + 8]
            if np.array_equal(w, CNAV_PREAMBLE) and crc_check(
                    bits[i : i + CNAV_MSG_BITS]):
                msg = CnavMessage(bits[i : i + CNAV_MSG_BITS])
                self.messages.append(msg)
                mt = msg.msg_type
                if mt in _FIELDS_BY_MT:
                    _decode_fields(bits[i : i + CNAV_MSG_BITS],
                                   _FIELDS_BY_MT[mt], self.ephemeris)
                    self.ephemeris.have.add(mt)
                    if mt == 30:
                        for attr, off, scale in _MT30_IONO:
                            setattr(self.iono, attr,
                                    _get(bits[i : i + CNAV_MSG_BITS],
                                         off, 8, signed=True) * 2.0**scale)
                        self.iono.valid = True
                self.frame_sync = True
                # bit k decoded from symbols [phase + 2k, phase + 2k + 1];
                # next message starts at bit i + 300
                self._tow_symbol = phase + 2 * (i + CNAV_MSG_BITS)
                self._tow_s = msg.tow_next_s
                found = True
                i += CNAV_MSG_BITS
            else:
                i += 1
        return found
