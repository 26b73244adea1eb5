"""RTCM 3.2 message encoder/decoder and TCP broadcast server.

Reference parity: src/algorithms/PVT/libs/rtcm.cc (5,767 LoC — bit-level
RTCM 3.2 serialization, MT1001-1045 + MSM1-7) and rtcm_printer.cc (TCP
server wiring, print cadence from rtklib_pvt_gs.cc).  This module is a
from-scratch encoder of the subset the receiver produces:

  MT1005/1006   station antenna reference point (DF002/003/021-028,+height)
  MT1029        unicode text string             (rtcm.cc print_MT1029)
  MT1033        receiver + antenna descriptors  (MT1008 superset)
  MT1001-1004   legacy GPS L1(/L2) observables (rtcm.cc print_MT1002 ...)
  MT1012        legacy GLONASS dual-band observables
  MT1019        GPS LNAV ephemeris            (rtcm.cc print_MT1019)
  MT1020        GLONASS GNAV ephemeris        (rtcm.cc print_MT1020)
  MT1045        Galileo F/NAV ephemeris       (rtcm.cc print_MT1045)
  MSM4 / MSM7   multi-signal observables for GPS (1074/1077),
                GLONASS (1084/1087), Galileo (1094/1097), BeiDou
                (1124/1127)                   (rtcm.cc print_MSM_4/7)

Every encoder has a matching decoder so tests can assert bit-exact
round-trips (the reference validates the same way in rtcm_test.cc).

Framing (rtcm.cc add_CRC / build_message): preamble 0xD3, 6 reserved bits,
10-bit payload length, payload, CRC-24Q over everything before the CRC.
"""

from __future__ import annotations

import dataclasses
import math
import socket
import threading

from ..telemetry.gnav import GlonassEphemeris
from ..telemetry.inav import GalileoEphemeris
from ..telemetry.lnav import GpsEphemeris
from ..utils.native import crc24q

PREAMBLE = 0xD3
SPEED_OF_LIGHT = 299792458.0
_MS_RANGE = SPEED_OF_LIGHT * 1e-3  # one light-millisecond in meters


# --------------------------------------------------------------------------
# bit-level plumbing
# --------------------------------------------------------------------------

class BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []

    def u(self, width: int, value: int) -> "BitWriter":
        v = int(value) & ((1 << width) - 1)
        self._bits.extend((v >> (width - 1 - k)) & 1 for k in range(width))
        return self

    def s(self, width: int, value: int) -> "BitWriter":
        """Two's-complement signed field."""
        return self.u(width, int(value) & ((1 << width) - 1))

    def sm(self, width: int, value: int) -> "BitWriter":
        """Sign-magnitude field (GLONASS intS fields, rtcm.cc set_DF111...)."""
        v = int(value)
        sign = 1 if v < 0 else 0
        return self.u(1, sign).u(width - 1, abs(v))

    def __len__(self) -> int:
        return len(self._bits)

    def to_bytes(self) -> bytes:
        bits = self._bits + [0] * (-len(self._bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self.pos = 0

    def u(self, width: int) -> int:
        v = 0
        for _ in range(width):
            byte = self._data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def s(self, width: int) -> int:
        v = self.u(width)
        if v & (1 << (width - 1)):
            v -= 1 << width
        return v

    def sm(self, width: int) -> int:
        sign = self.u(1)
        mag = self.u(width - 1)
        return -mag if sign else mag


def frame(payload: bytes) -> bytes:
    """Wrap an RTCM payload in the transport frame (rtcm.cc add_CRC)."""
    head = bytes([PREAMBLE, (len(payload) >> 8) & 0x03, len(payload) & 0xFF])
    crc = crc24q(head + payload)
    return head + payload + bytes([(crc >> 16) & 0xFF, (crc >> 8) & 0xFF,
                                   crc & 0xFF])


def deframe(data: bytes) -> tuple[int, bytes]:
    """Validate a frame; return (message_number, payload). Raises ValueError."""
    if len(data) < 6 or data[0] != PREAMBLE:
        raise ValueError("bad preamble")
    length = ((data[1] & 0x03) << 8) | data[2]
    if len(data) < 3 + length + 3:
        raise ValueError("truncated frame")
    payload = data[3:3 + length]
    crc = int.from_bytes(data[3 + length:6 + length], "big")
    if crc != crc24q(data[:3 + length]):
        raise ValueError("CRC mismatch")
    msgnum = (payload[0] << 4) | (payload[1] >> 4) if payload else 0
    return msgnum, payload


def iter_frames(stream: bytes):
    """Split a concatenated RTCM byte stream into (msgnum, payload) pairs."""
    i = 0
    while i + 6 <= len(stream):
        if stream[i] != PREAMBLE:
            i += 1
            continue
        length = ((stream[i + 1] & 0x03) << 8) | stream[i + 2]
        end = i + 3 + length + 3
        if end > len(stream):
            # false preamble with bogus length, or truncated tail
            i += 1
            continue
        try:
            yield deframe(stream[i:end])
        except ValueError:
            i += 1
            continue
        i = end


def _round(x: float) -> int:
    return int(round(x))


# --------------------------------------------------------------------------
# MT1005 / MT1006 — station ARP
# --------------------------------------------------------------------------

def encode_mt1005(station_id: int, ecef_m, height_m: float | None = None,
                  gps: bool = True, glonass: bool = False,
                  galileo: bool = False) -> bytes:
    """Station antenna reference point (rtcm.cc print_MT1005/print_MT1006).
    With height_m -> MT1006."""
    w = BitWriter()
    w.u(12, 1006 if height_m is not None else 1005)
    w.u(12, station_id)
    w.u(6, 0)                       # ITRF realization year DF021
    w.u(1, int(gps)).u(1, int(glonass)).u(1, int(galileo))
    w.u(1, 0)                       # reference-station indicator
    w.s(38, _round(ecef_m[0] / 1e-4))
    w.u(1, 0).u(1, 0)               # oscillator / reserved
    w.s(38, _round(ecef_m[1] / 1e-4))
    w.u(2, 0)                       # quarter cycle indicator
    w.s(38, _round(ecef_m[2] / 1e-4))
    if height_m is not None:
        w.u(16, _round(height_m / 1e-4))
    return frame(w.to_bytes())


def decode_mt1005(payload: bytes) -> dict:
    r = BitReader(payload)
    msgnum = r.u(12)
    out = {"msgnum": msgnum, "station_id": r.u(12)}
    r.u(6)
    out["gps"], out["glonass"], out["galileo"] = (bool(r.u(1)) for _ in
                                                  range(3))
    r.u(1)
    x = r.s(38); r.u(2)
    y = r.s(38); r.u(2)
    z = r.s(38)
    out["ecef_m"] = (x * 1e-4, y * 1e-4, z * 1e-4)
    if msgnum == 1006:
        out["height_m"] = r.u(16) * 1e-4
    return out


# --------------------------------------------------------------------------
# MT1029 — unicode text string (rtcm.cc print_MT1029 :2008)
# --------------------------------------------------------------------------

def encode_mt1029(station_id: int, mjd: int, utc_seconds: int,
                  message: str) -> bytes:
    """Unicode text string (DF051 MJD, DF052 UTC s-of-day, DF138 code
    units, DF139 UTF-8 byte count; rtcm.cc print_MT1029)."""
    data = message.encode("utf-8")
    if len(data) > 255:
        raise ValueError("MT1029 text limited to 255 UTF-8 bytes")
    if len(message) > 127:
        raise ValueError("MT1029 text limited to 127 characters (DF138)")
    w = BitWriter()
    w.u(12, 1029).u(12, station_id).u(16, mjd).u(17, utc_seconds)
    w.u(7, len(message)).u(8, len(data))
    payload = w.to_bytes()
    return frame(payload + data)


def decode_mt1029(payload: bytes) -> dict:
    r = BitReader(payload)
    assert r.u(12) == 1029
    out = {"station_id": r.u(12), "mjd": r.u(16), "utc_seconds": r.u(17)}
    r.u(7)
    nbytes = r.u(8)
    start = (r.pos + 7) // 8
    out["message"] = payload[start:start + nbytes].decode("utf-8")
    return out


# --------------------------------------------------------------------------
# MT1033 — receiver and antenna descriptors (rtcm.cc MT1008 superset)
# --------------------------------------------------------------------------

def _put_counted_ascii(w: BitWriter, text: str) -> None:
    try:
        data = text.encode("ascii")
    except UnicodeEncodeError as e:
        raise ValueError(
            f"RTCM descriptor fields are ASCII (DF030/033/228/230/232): "
            f"{text!r}") from e
    if len(data) > 31:
        raise ValueError(f"RTCM descriptor limited to 31 characters: "
                         f"{text!r}")
    w.u(8, len(data))
    for b in data:
        w.u(8, b)


def _get_counted_ascii(r: BitReader) -> str:
    n = r.u(8)
    return bytes(r.u(8) for _ in range(n)).decode("ascii")


def encode_mt1008(station_id: int, antenna: str, setup_id: int = 0,
                  antenna_serial: str = "") -> bytes:
    """Antenna descriptor and serial number (DF029-033; rtcm.cc MT1008 —
    the legacy subset of MT1033)."""
    w = BitWriter()
    w.u(12, 1008).u(12, station_id)
    _put_counted_ascii(w, antenna)
    w.u(8, setup_id)
    _put_counted_ascii(w, antenna_serial)
    return frame(w.to_bytes())


def decode_mt1008(payload: bytes) -> dict:
    r = BitReader(payload)
    assert r.u(12) == 1008
    out = {"station_id": r.u(12), "antenna": _get_counted_ascii(r)}
    out["setup_id"] = r.u(8)
    out["antenna_serial"] = _get_counted_ascii(r)
    return out


def encode_mt1033(station_id: int, antenna: str, setup_id: int = 0,
                  antenna_serial: str = "", receiver: str = "",
                  firmware: str = "", receiver_serial: str = "") -> bytes:
    """Receiver and antenna descriptors (DF029/030 antenna, DF031 setup,
    DF032/033 serial, DF227-232 receiver type/firmware/serial)."""
    w = BitWriter()
    w.u(12, 1033).u(12, station_id)
    _put_counted_ascii(w, antenna)
    w.u(8, setup_id)
    for text in (antenna_serial, receiver, firmware, receiver_serial):
        _put_counted_ascii(w, text)
    return frame(w.to_bytes())


def decode_mt1033(payload: bytes) -> dict:
    r = BitReader(payload)
    assert r.u(12) == 1033
    out = {"station_id": r.u(12), "antenna": _get_counted_ascii(r)}
    out["setup_id"] = r.u(8)
    for key in ("antenna_serial", "receiver", "firmware", "receiver_serial"):
        out[key] = _get_counted_ascii(r)
    return out


# --------------------------------------------------------------------------
# MT1002 — legacy GPS L1 observables
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RtcmObs:
    """One satellite observation for legacy RTCM encoding (band-2 fields
    feed the dual-frequency MT1003/1004/1011/1012)."""
    prn: int
    pseudorange_m: float
    carrier_phase_cycles: float = 0.0
    lock_time_s: float = 0.0
    cn0_dbhz: float = 0.0
    doppler_hz: float = 0.0
    wavelength_m: float = SPEED_OF_LIGHT / 1575.42e6
    # GLONASS frequency-channel number k in [-7, 6] (DF040 = k + 7)
    fdma_k: int = 0
    # optional second band (L2 / G2)
    pseudorange2_m: float | None = None
    carrier_phase2_cycles: float = 0.0
    lock2_time_s: float = 0.0
    cn0_2_dbhz: float = 0.0
    wavelength2_m: float = SPEED_OF_LIGHT / 1227.60e6


def _df402_lock(lock_s: float) -> int:
    """DF402/DF013 lock-time indicator (rtcm.cc lock_time mapping)."""
    t = lock_s
    if t < 24: return max(int(t), 0)
    if t < 72: return int((t + 24) / 2)
    if t < 168: return int((t + 120) / 4)
    if t < 360: return int((t + 408) / 8)
    if t < 744: return int((t + 1176) / 16)
    if t < 937: return int((t + 3096) / 32)
    return 127


def encode_mt1002(station_id: int, tow_s: float,
                  observations: list[RtcmObs]) -> bytes:
    """GPS L1-only extended observables (rtcm.cc print_MT1002)."""
    w = BitWriter()
    w.u(12, 1002)
    w.u(12, station_id)
    w.u(30, _round(tow_s * 1e3) % 604800000)
    w.u(1, 0)                       # synchronous flag
    w.u(5, len(observations))
    w.u(1, 0).u(3, 0)               # smoothing flags
    for ob in observations:
        amb = int(ob.pseudorange_m // _MS_RANGE)
        mod = ob.pseudorange_m - amb * _MS_RANGE
        phase_m = ob.carrier_phase_cycles * ob.wavelength_m
        diff = phase_m - ob.pseudorange_m
        # DF012 L1 phaserange - pseudorange: the 20-bit field at 0.0005 m
        # spans +-262.144 m, so wrap at the field span (not the RTCM prose
        # +-292.7 m figure) to avoid silent two's-complement aliasing
        diff = (diff + 262.144) % 524.288 - 262.144
        w.u(6, ob.prn)
        w.u(1, 0)                   # code indicator: C/A
        w.u(24, _round(mod / 0.02))
        w.s(20, _round(diff / 5e-4))
        w.u(7, _df402_lock(ob.lock_time_s))
        w.u(8, amb)
        w.u(8, _round(ob.cn0_dbhz / 0.25))
    return frame(w.to_bytes())


def decode_mt1002(payload: bytes) -> dict:
    r = BitReader(payload)
    out = {"msgnum": r.u(12), "station_id": r.u(12),
           "tow_s": r.u(30) / 1e3}
    r.u(1)
    n = r.u(5)
    r.u(4)
    obs = []
    for _ in range(n):
        prn = r.u(6)
        r.u(1)
        mod = r.u(24) * 0.02
        diff = r.s(20) * 5e-4
        lock = r.u(7)
        amb = r.u(8)
        cn0 = r.u(8) * 0.25
        pr = amb * _MS_RANGE + mod
        obs.append({"prn": prn, "pseudorange_m": pr,
                    "phase_minus_code_m": diff, "lock": lock,
                    "cn0_dbhz": cn0})
    out["observations"] = obs
    return out


def _wrap_phase_diff(phase_m: float, pr_m: float) -> float:
    """DF012/DF018-style (phaserange - pseudorange): the 20-bit field at
    0.0005 m spans +-262.144 m; wrap at the field span to avoid silent
    two's-complement aliasing (rtcm.cc set_DF012 gate)."""
    return (phase_m - pr_m + 262.144) % 524.288 - 262.144


def encode_mt1001(station_id: int, tow_s: float,
                  observations: list[RtcmObs]) -> bytes:
    """GPS L1-only basic observables (rtcm.cc print_MT1001 — MT1002
    without the ambiguity/CNR extension)."""
    w = BitWriter()
    w.u(12, 1001)
    w.u(12, station_id)
    w.u(30, _round(tow_s * 1e3) % 604800000)
    w.u(1, 0)
    w.u(5, len(observations))
    w.u(1, 0).u(3, 0)
    for ob in observations:
        mod = ob.pseudorange_m % _MS_RANGE
        diff = _wrap_phase_diff(
            ob.carrier_phase_cycles * ob.wavelength_m, ob.pseudorange_m)
        w.u(6, ob.prn)
        w.u(1, 0)
        w.u(24, _round(mod / 0.02))
        w.s(20, _round(diff / 5e-4))
        w.u(7, _df402_lock(ob.lock_time_s))
    return frame(w.to_bytes())


def decode_mt1001(payload: bytes) -> dict:
    r = BitReader(payload)
    out = {"msgnum": r.u(12), "station_id": r.u(12), "tow_s": r.u(30) / 1e3}
    r.u(1)
    n = r.u(5)
    r.u(4)
    obs = []
    for _ in range(n):
        prn = r.u(6)
        r.u(1)
        mod = r.u(24) * 0.02
        diff = r.s(20) * 5e-4
        lock = r.u(7)
        obs.append({"prn": prn, "pseudorange_mod_1ms_m": mod,
                    "phase_minus_code_m": diff, "lock": lock})
    out["observations"] = obs
    return out


def _put_gps_dual(w: BitWriter, ob: RtcmObs, extended: bool) -> None:
    """Per-satellite body shared by MT1003 (basic) / MT1004 (extended):
    DF009-DF013 [DF014 DF015] DF016-DF019 [DF020] (rtcm.cc print_MT1004)."""
    amb = int(ob.pseudorange_m // _MS_RANGE)
    mod = ob.pseudorange_m - amb * _MS_RANGE
    diff1 = _wrap_phase_diff(
        ob.carrier_phase_cycles * ob.wavelength_m, ob.pseudorange_m)
    w.u(6, ob.prn)
    w.u(1, 0)                       # DF010 L1 code: C/A
    w.u(24, _round(mod / 0.02))
    w.s(20, _round(diff1 / 5e-4))
    w.u(7, _df402_lock(ob.lock_time_s))
    if extended:
        w.u(8, amb)
        w.u(8, _round(ob.cn0_dbhz / 0.25))
    pr2 = ob.pseudorange2_m if ob.pseudorange2_m is not None \
        else ob.pseudorange_m
    d21 = pr2 - ob.pseudorange_m
    diff2 = _wrap_phase_diff(
        ob.carrier_phase2_cycles * ob.wavelength2_m, ob.pseudorange_m)
    w.u(2, 0)                       # DF016 L2 code: C/A or L2C
    # DF017 L2-L1 pseudorange difference (14 bit, 0.02 m); sentinel -8192
    # when no valid L2 range
    w.s(14, -8192 if ob.pseudorange2_m is None
        else max(-8191, min(8191, _round(d21 / 0.02))))
    w.s(20, _round(diff2 / 5e-4))
    w.u(7, _df402_lock(ob.lock2_time_s))
    if extended:
        w.u(8, _round(ob.cn0_2_dbhz / 0.25))


def _get_gps_dual(r: BitReader, extended: bool) -> dict:
    o = {"prn": r.u(6)}
    r.u(1)
    mod = r.u(24) * 0.02
    o["phase_minus_code_m"] = r.s(20) * 5e-4
    o["lock"] = r.u(7)
    if extended:
        amb = r.u(8)
        o["cn0_dbhz"] = r.u(8) * 0.25
        o["pseudorange_m"] = amb * _MS_RANGE + mod
    else:
        o["pseudorange_mod_1ms_m"] = mod
    r.u(2)
    d21 = r.s(14)
    o["pr2_minus_pr1_m"] = None if d21 == -8192 else d21 * 0.02
    o["phase2_minus_code_m"] = r.s(20) * 5e-4
    o["lock2"] = r.u(7)
    if extended:
        o["cn0_2_dbhz"] = r.u(8) * 0.25
    return o


def encode_mt1003(station_id: int, tow_s: float,
                  observations: list[RtcmObs]) -> bytes:
    """GPS L1+L2 basic observables (rtcm.cc print_MT1003)."""
    w = BitWriter()
    w.u(12, 1003)
    w.u(12, station_id)
    w.u(30, _round(tow_s * 1e3) % 604800000)
    w.u(1, 0)
    w.u(5, len(observations))
    w.u(1, 0).u(3, 0)
    for ob in observations:
        _put_gps_dual(w, ob, extended=False)
    return frame(w.to_bytes())


def encode_mt1004(station_id: int, tow_s: float,
                  observations: list[RtcmObs]) -> bytes:
    """GPS L1+L2 extended observables (rtcm.cc print_MT1004 :722 — the
    reference's full-rate legacy GPS message)."""
    w = BitWriter()
    w.u(12, 1004)
    w.u(12, station_id)
    w.u(30, _round(tow_s * 1e3) % 604800000)
    w.u(1, 0)
    w.u(5, len(observations))
    w.u(1, 0).u(3, 0)
    for ob in observations:
        _put_gps_dual(w, ob, extended=True)
    return frame(w.to_bytes())


def _decode_mt1003_1004(payload: bytes) -> dict:
    r = BitReader(payload)
    out = {"msgnum": r.u(12), "station_id": r.u(12), "tow_s": r.u(30) / 1e3}
    extended = out["msgnum"] == 1004
    r.u(1)
    n = r.u(5)
    r.u(4)
    out["observations"] = [_get_gps_dual(r, extended) for _ in range(n)]
    return out


decode_mt1003 = _decode_mt1003_1004
decode_mt1004 = _decode_mt1003_1004


def encode_mt1012(station_id: int, glonass_tod_s: float,
                  observations: list[RtcmObs]) -> bytes:
    """GLONASS L1+L2 extended observables (rtcm.cc print_MT1012 :1407):
    header carries DF034 (27-bit ms of GLONASS day); per satellite
    DF038-DF045 + G2 DF046-DF050; DF040 = frequency channel k+7."""
    w = BitWriter()
    w.u(12, 1012)
    w.u(12, station_id)
    w.u(27, _round(glonass_tod_s * 1e3) % 86400000)
    w.u(1, 0)
    w.u(5, len(observations))
    w.u(1, 0).u(3, 0)
    for ob in observations:
        amb = int(ob.pseudorange_m // _MS_RANGE)
        mod = ob.pseudorange_m - amb * _MS_RANGE
        diff1 = _wrap_phase_diff(
            ob.carrier_phase_cycles * ob.wavelength_m, ob.pseudorange_m)
        w.u(6, ob.prn)              # DF038 slot
        w.u(1, 0)                   # DF039 code
        w.u(5, ob.fdma_k + 7)       # DF040
        w.u(25, _round(mod / 0.02)) # DF041
        w.s(20, _round(diff1 / 5e-4))
        w.u(7, _df402_lock(ob.lock_time_s))
        w.u(7, amb)                 # DF044
        w.u(8, _round(ob.cn0_dbhz / 0.25))
        pr2 = ob.pseudorange2_m
        d21 = 0.0 if pr2 is None else pr2 - ob.pseudorange_m
        diff2 = _wrap_phase_diff(
            ob.carrier_phase2_cycles * ob.wavelength2_m, ob.pseudorange_m)
        w.u(2, 0)                   # DF046
        w.s(14, -8192 if pr2 is None
            else max(-8191, min(8191, _round(d21 / 0.02))))
        w.s(20, _round(diff2 / 5e-4))
        w.u(7, _df402_lock(ob.lock2_time_s))
        w.u(8, _round(ob.cn0_2_dbhz / 0.25))
    return frame(w.to_bytes())


def decode_mt1012(payload: bytes) -> dict:
    r = BitReader(payload)
    out = {"msgnum": r.u(12), "station_id": r.u(12),
           "glonass_tod_s": r.u(27) / 1e3}
    r.u(1)
    n = r.u(5)
    r.u(4)
    obs = []
    for _ in range(n):
        o = {"slot": r.u(6)}
        r.u(1)
        o["fdma_k"] = r.u(5) - 7
        mod = r.u(25) * 0.02
        o["phase_minus_code_m"] = r.s(20) * 5e-4
        o["lock"] = r.u(7)
        o["pseudorange_m"] = r.u(7) * _MS_RANGE + mod
        o["cn0_dbhz"] = r.u(8) * 0.25
        r.u(2)
        d21 = r.s(14)
        o["pr2_minus_pr1_m"] = None if d21 == -8192 else d21 * 0.02
        o["phase2_minus_code_m"] = r.s(20) * 5e-4
        o["lock2"] = r.u(7)
        o["cn0_2_dbhz"] = r.u(8) * 0.25
        obs.append(o)
    out["observations"] = obs
    return out


# --------------------------------------------------------------------------
# MT1019 — GPS ephemeris
# --------------------------------------------------------------------------

def encode_mt1019(eph: GpsEphemeris) -> bytes:
    """GPS LNAV ephemeris, ICD LSB scaling (rtcm.cc print_MT1019,
    DF071-DF103).  Angles in the dataclass are semicircles (lnav.py)."""
    w = BitWriter()
    w.u(12, 1019)
    w.u(6, eph.prn)
    w.u(10, eph.week % 1024)
    w.u(4, 0)                       # SV accuracy
    w.u(2, 0)                       # code on L2
    w.s(14, _round(eph.idot / 2**-43))
    w.u(8, eph.iode)
    w.u(16, _round(eph.toc / 16))
    w.s(8, _round(eph.af2 / 2**-55))
    w.s(16, _round(eph.af1 / 2**-43))
    w.s(22, _round(eph.af0 / 2**-31))
    w.u(10, eph.iodc)
    w.s(16, _round(eph.crs / 2**-5))
    w.s(16, _round(eph.delta_n / 2**-43))
    w.s(32, _round(eph.m0 / 2**-31))
    w.s(16, _round(eph.cuc / 2**-29))
    w.u(32, _round(eph.e / 2**-33))
    w.s(16, _round(eph.cus / 2**-29))
    w.u(32, _round(eph.sqrt_a / 2**-19))
    w.u(16, _round(eph.toe / 16))
    w.s(16, _round(eph.cic / 2**-29))
    w.s(32, _round(eph.omega0 / 2**-31))
    w.s(16, _round(eph.cis / 2**-29))
    w.s(32, _round(eph.i0 / 2**-31))
    w.s(16, _round(eph.crc / 2**-5))
    w.s(32, _round(eph.omega / 2**-31))
    w.s(24, _round(eph.omega_dot / 2**-43))
    w.s(8, _round(eph.tgd / 2**-31))
    w.u(6, eph.sv_health)
    w.u(1, 0)                       # L2P data flag
    w.u(1, 0)                       # fit interval
    return frame(w.to_bytes())


def decode_mt1019(payload: bytes) -> GpsEphemeris:
    r = BitReader(payload)
    assert r.u(12) == 1019
    e = GpsEphemeris()
    e.prn = r.u(6)
    e.week = r.u(10)
    r.u(4); r.u(2)
    e.idot = r.s(14) * 2**-43
    e.iode = r.u(8)
    e.toc = r.u(16) * 16.0
    e.af2 = r.s(8) * 2**-55
    e.af1 = r.s(16) * 2**-43
    e.af0 = r.s(22) * 2**-31
    e.iodc = r.u(10)
    e.crs = r.s(16) * 2**-5
    e.delta_n = r.s(16) * 2**-43
    e.m0 = r.s(32) * 2**-31
    e.cuc = r.s(16) * 2**-29
    e.e = r.u(32) * 2**-33
    e.cus = r.s(16) * 2**-29
    e.sqrt_a = r.u(32) * 2**-19
    e.toe = r.u(16) * 16.0
    e.cic = r.s(16) * 2**-29
    e.omega0 = r.s(32) * 2**-31
    e.cis = r.s(16) * 2**-29
    e.i0 = r.s(32) * 2**-31
    e.crc = r.s(16) * 2**-5
    e.omega = r.s(32) * 2**-31
    e.omega_dot = r.s(24) * 2**-43
    e.tgd = r.s(8) * 2**-31
    e.sv_health = r.u(6)
    return e


# --------------------------------------------------------------------------
# MT1020 — GLONASS ephemeris (sign-magnitude state vector)
# --------------------------------------------------------------------------

def encode_mt1020(eph: GlonassEphemeris) -> bytes:
    """GLONASS GNAV ephemeris (rtcm.cc print_MT1020, DF038-DF136).
    State-vector fields are sign-magnitude per the GLONASS ICD."""
    w = BitWriter()
    w.u(12, 1020)
    w.u(6, eph.slot)
    w.u(5, eph.freq_channel + 7)
    w.u(1, 0).u(1, 0).u(2, 0)       # alm health / availability / P1
    tk = int(eph.tk_s)
    w.u(5, tk // 3600).u(6, (tk % 3600) // 60).u(1, (tk % 60) // 30)
    w.u(1, eph.health_bn & 1)
    w.u(1, 0)                       # P2
    w.u(7, _round(eph.tb_s / 900))
    w.sm(24, _round(eph.vx_kms / 2**-20))
    w.sm(27, _round(eph.x_km / 2**-11))
    w.sm(5, _round(eph.ax_kms2 / 2**-30))
    w.sm(24, _round(eph.vy_kms / 2**-20))
    w.sm(27, _round(eph.y_km / 2**-11))
    w.sm(5, _round(eph.ay_kms2 / 2**-30))
    w.sm(24, _round(eph.vz_kms / 2**-20))
    w.sm(27, _round(eph.z_km / 2**-11))
    w.sm(5, _round(eph.az_kms2 / 2**-30))
    w.u(1, 0)                       # P3
    w.sm(11, _round(eph.gamma_n / 2**-40))
    w.u(2, 0).u(1, 0)               # P / ln
    w.sm(22, _round(eph.tau_n_s / 2**-30))
    w.sm(5, 0)                      # delta_tau_n
    w.u(5, 0)                       # En
    w.u(1, 0).u(4, 0)               # P4 / Ft
    w.u(11, eph.nt_days)
    w.u(2, 0).u(1, 0)               # M / availability
    w.u(11, 0)                      # NA
    w.sm(32, 0)                     # tau_c
    w.u(5, 0)                       # N4
    w.sm(22, 0)                     # tau_gps
    w.u(1, 0)                       # ln (fifth string)
    w.u(7, 0)                       # reserved
    return frame(w.to_bytes())


def decode_mt1020(payload: bytes) -> GlonassEphemeris:
    r = BitReader(payload)
    assert r.u(12) == 1020
    e = GlonassEphemeris()
    e.slot = r.u(6)
    e.freq_channel = r.u(5) - 7
    r.u(4)
    h, m, s30 = r.u(5), r.u(6), r.u(1)
    e.tk_s = h * 3600 + m * 60 + s30 * 30
    e.health_bn = r.u(1)
    r.u(1)
    e.tb_s = r.u(7) * 900.0
    e.vx_kms = r.sm(24) * 2**-20
    e.x_km = r.sm(27) * 2**-11
    e.ax_kms2 = r.sm(5) * 2**-30
    e.vy_kms = r.sm(24) * 2**-20
    e.y_km = r.sm(27) * 2**-11
    e.ay_kms2 = r.sm(5) * 2**-30
    e.vz_kms = r.sm(24) * 2**-20
    e.z_km = r.sm(27) * 2**-11
    e.az_kms2 = r.sm(5) * 2**-30
    r.u(1)
    e.gamma_n = r.sm(11) * 2**-40
    r.u(3)
    e.tau_n_s = r.sm(22) * 2**-30
    r.sm(5); r.u(5); r.u(5)
    e.nt_days = r.u(11)
    return e


# --------------------------------------------------------------------------
# MT1045 — Galileo F/NAV ephemeris
# --------------------------------------------------------------------------

def encode_mt1045(eph: GalileoEphemeris) -> bytes:
    """Galileo F/NAV ephemeris (rtcm.cc print_MT1045, DF252+).
    Angles in the dataclass are semicircles (inav.py / fnav.py)."""
    w = BitWriter()
    w.u(12, 1045)
    w.u(6, eph.prn)
    w.u(12, eph.wn)
    w.u(10, eph.iod_nav)
    w.u(8, 0)                       # SISA
    w.s(14, _round(eph.idot / 2**-43))
    w.u(14, _round(eph.toc / 60))
    w.s(6, _round(eph.af2 / 2**-59))
    w.s(21, _round(eph.af1 / 2**-46))
    w.s(31, _round(eph.af0 / 2**-34))
    w.s(16, _round(eph.crs / 2**-5))
    w.s(16, _round(eph.delta_n / 2**-43))
    w.s(32, _round(eph.m0 / 2**-31))
    w.s(16, _round(eph.cuc / 2**-29))
    w.u(32, _round(eph.e / 2**-33))
    w.s(16, _round(eph.cus / 2**-29))
    w.u(32, _round(eph.sqrt_a / 2**-19))
    w.u(14, _round(eph.toe / 60))
    w.s(16, _round(eph.cic / 2**-29))
    w.s(32, _round(eph.omega0 / 2**-31))
    w.s(16, _round(eph.cis / 2**-29))
    w.s(32, _round(eph.i0 / 2**-31))
    w.s(16, _round(eph.crc / 2**-5))
    w.s(32, _round(eph.omega / 2**-31))
    w.s(24, _round(eph.omega_dot / 2**-43))
    w.s(10, 0)                      # BGD E5a/E1
    w.u(2, 0).u(1, 0)               # E5a health / data validity
    w.u(7, 0)                       # reserved
    return frame(w.to_bytes())


def decode_mt1045(payload: bytes) -> GalileoEphemeris:
    r = BitReader(payload)
    assert r.u(12) == 1045
    e = GalileoEphemeris()
    e.prn = r.u(6)
    e.wn = r.u(12)
    e.iod_nav = r.u(10)
    r.u(8)
    e.idot = r.s(14) * 2**-43
    e.toc = r.u(14) * 60.0
    e.af2 = r.s(6) * 2**-59
    e.af1 = r.s(21) * 2**-46
    e.af0 = r.s(31) * 2**-34
    e.crs = r.s(16) * 2**-5
    e.delta_n = r.s(16) * 2**-43
    e.m0 = r.s(32) * 2**-31
    e.cuc = r.s(16) * 2**-29
    e.e = r.u(32) * 2**-33
    e.cus = r.s(16) * 2**-29
    e.sqrt_a = r.u(32) * 2**-19
    e.toe = r.u(14) * 60.0
    e.cic = r.s(16) * 2**-29
    e.omega0 = r.s(32) * 2**-31
    e.cis = r.s(16) * 2**-29
    e.i0 = r.s(32) * 2**-31
    e.crc = r.s(16) * 2**-5
    e.omega = r.s(32) * 2**-31
    e.omega_dot = r.s(24) * 2**-43
    return e


# --------------------------------------------------------------------------
# MSM4 / MSM7 — multi-signal observables
# --------------------------------------------------------------------------

# RTCM MSM signal IDs (Tables 3.5-91..3.5-108) for the signals this
# receiver produces (rtcm.cc signal_ID tables).
MSM_SIGNAL_ID = {
    "GPS": {"1C": 2, "2S": 15, "L5": 22},
    "GLONASS": {"1G": 2, "2G": 8},
    "Galileo": {"1B": 4, "5X": 22},
    "BeiDou": {"B1": 2, "B3": 8},
}
MSM_BASE = {"GPS": 1070, "GLONASS": 1080, "Galileo": 1090, "BeiDou": 1120}
_SYS_BY_BASE = {v: k for k, v in MSM_BASE.items()}

# receiver signal_id -> MSM system (rtcm.cc signal dispatch in print_MSM_*)
SYSTEM_OF_SIGNAL = {"1C": "GPS", "2S": "GPS", "L5": "GPS",
                    "1B": "Galileo", "5X": "Galileo",
                    "1G": "GLONASS", "2G": "GLONASS",
                    "B1": "BeiDou", "B3": "BeiDou"}


def encode_ephemeris(eph) -> bytes | None:
    """Dispatch an ephemeris dataclass to its RTCM message
    (rtklib_pvt_gs.cc ephemeris print cadence)."""
    if isinstance(eph, GpsEphemeris):
        return encode_mt1019(eph)
    if isinstance(eph, GalileoEphemeris):
        return encode_mt1045(eph)
    if isinstance(eph, GlonassEphemeris):
        return encode_mt1020(eph)
    return None


@dataclasses.dataclass
class MsmObs:
    """One satellite-signal observation for MSM encoding."""
    sat: int                    # satellite id 1..64 (PRN / slot)
    signal: str                 # key into MSM_SIGNAL_ID[system]
    pseudorange_m: float
    phase_range_m: float = 0.0  # carrier phase expressed in meters
    phase_rate_ms: float = 0.0  # phase range rate [m/s] (MSM7 only)
    lock_time_s: float = 0.0
    cn0_dbhz: float = 0.0
    wavelength_m: float = 0.0   # enables integer-cycle alignment (DF401/406)


# MSM fine-field invalid sentinels and metre spans (DF400/401/405/406).
# The fine phase span is 2**-8 ms of range (= 1171.3 m, the reference's
# literal 1171.0 gate in set_DF401/set_DF406); fine pseudorange spans
# 2**-10 ms (= 292.7 m).
_MSM_PHASE_SPAN_M = 1171.0
_MSM_PR_SPAN_M = 292.7

# field layout per MSM level (RTCM 10403 Tables 3.5-75..80; rtcm.cc
# print_MSM_1..7): (DF397 integer-ms, DF399 rough rate + ext-info,
# fine-pr bits, fine-phase bits, lock bits, cnr bits, DF404 fine rate)
_MSM_LAYOUT = {
    1: dict(df397=False, rate=False, pr=15, ph=0, lock=0, cnr=0, frate=False),
    2: dict(df397=False, rate=False, pr=0, ph=22, lock=4, cnr=0, frate=False),
    3: dict(df397=False, rate=False, pr=15, ph=22, lock=4, cnr=0,
            frate=False),
    4: dict(df397=True, rate=False, pr=15, ph=22, lock=4, cnr=6,
            frate=False),
    5: dict(df397=True, rate=True, pr=15, ph=22, lock=4, cnr=6, frate=True),
    6: dict(df397=True, rate=False, pr=20, ph=24, lock=10, cnr=10,
            frate=False),
    7: dict(df397=True, rate=True, pr=20, ph=24, lock=10, cnr=10,
            frate=True),
}
_SENT_FINE_PR = {15: -16384, 20: -524288}        # DF400 / DF405
_SENT_FINE_PHASE = {22: -2097152, 24: -8388608}  # DF401 / DF406
_PR_SCALE = {15: 2.0 ** -24, 20: 2.0 ** -29}
_PH_SCALE = {22: 2.0 ** -29, 24: 2.0 ** -31}


def _df402_msm_lock(lock_s: float) -> int:
    """DF402 4-bit MSM lock-time indicator, RTCM Table 3.5-74
    (rtcm.cc msm_lock_time_indicator): 0 below 32 s, then one step per
    power-of-two doubling up to >=524288 s -> 15."""
    if lock_s < 32.0:
        return 0
    return min(int(math.floor(math.log2(lock_s))) - 4, 15)


def glonass_msm_epoch(gps_tow_ms: int, leap_s: int = 18) -> int:
    """GLONASS MSM epoch: DF416 (3-bit day of week) + DF034 (27-bit ms of
    GLONASS day), packed into the header's 30-bit epoch field (rtcm.cc
    set_DF034/set_DF416).  GLONASS time = UTC(SU) + 3 h = GPS - leap + 3 h."""
    t = (int(gps_tow_ms) - leap_s * 1000 + 3 * 3600 * 1000) % 604800000
    dow, tod = divmod(t, 86400000)
    return (int(dow) << 27) | int(tod)


def _df407_lock(lock_s: float) -> int:
    """DF407 high-resolution lock-time indicator (rtcm.cc lock_time MSM
    variant; piecewise-doubling bins)."""
    ms = int(lock_s * 1e3)
    if ms < 64:
        return max(ms, 0)
    for k in range(1, 21):
        if ms < (1 << (k + 6)):
            return (ms >> k) + k * 32
    return 704


def encode_msm(system: str, msm: int, station_id: int, epoch_ms: int,
               observations: list[MsmObs]) -> bytes:
    """Encode MSM1-7 for one constellation (rtcm.cc print_MSM_1..7
    :2862/:3030 and get_MSM_header; field sets per _MSM_LAYOUT)."""
    lay = _MSM_LAYOUT.get(msm)
    if lay is None:
        raise ValueError(f"unknown MSM level {msm}")
    sig_ids = MSM_SIGNAL_ID[system]
    sats = sorted({ob.sat for ob in observations})
    sigs = sorted({sig_ids[ob.signal] for ob in observations})
    cell = {(ob.sat, sig_ids[ob.signal]): ob for ob in observations}

    w = BitWriter()
    w.u(12, MSM_BASE[system] + msm)
    w.u(12, station_id)
    w.u(30, epoch_ms)
    w.u(1, 0)                       # multiple-message bit
    w.u(3, 0)                       # IODS
    w.u(7, 0)                       # reserved
    w.u(2, 0).u(2, 0).u(1, 0).u(3, 0)   # clock steering/ext clock/smoothing
    for i in range(1, 65):
        w.u(1, int(i in sats))
    for i in range(1, 33):
        w.u(1, int(i in sigs))
    cells = [(s, g) for s in sats for g in sigs]
    for c in cells:
        w.u(1, int(c in cell))

    # satellite data: rough range (+ ext info / rough rate per layout)
    rough = {}
    for s in sats:
        prs = [ob.pseudorange_m for (sat, _), ob in cell.items()
               if sat == s]
        # DF397/DF398: nearest 1/1024-ms rough range of the satellite mean,
        # keeping every signal's fine range within the DF400 15-bit span
        total = _round(sum(prs) / len(prs) / _MS_RANGE * 1024)
        ms_int, rough_mod = divmod(total, 1024)
        rough[s] = (ms_int if lay["df397"] else 0, rough_mod)
        if lay["df397"]:
            w.u(8, ms_int)
    if lay["rate"]:
        for s in sats:
            w.u(4, 0)               # extended satellite info
    for s in sats:
        w.u(10, rough[s][1])
    rough_rate = {}
    if lay["rate"]:
        for s in sats:
            rates = [ob.phase_rate_ms for (sat, _), ob in cell.items()
                     if sat == s]
            rough_rate[s] = _round(sum(rates) / len(rates))
            w.s(14, rough_rate[s])

    # signal data
    present = [cell[c] for c in cells if c in cell]

    def sat_base(ob):
        return (rough[ob.sat][0] + rough[ob.sat][1] / 1024) * _MS_RANGE

    if lay["pr"]:
        for ob in present:
            fine_m = ob.pseudorange_m - sat_base(ob)
            if not lay["df397"]:
                # MSM1-3 carry no integer ms: fine range is vs the
                # satellite's modulo-1ms rough range
                fine_m = ((fine_m + _MS_RANGE / 2) % _MS_RANGE
                          - _MS_RANGE / 2)
            if abs(fine_m) > _MSM_PR_SPAN_M:
                raw = _SENT_FINE_PR[lay["pr"]]
            else:
                raw = _round(fine_m / _MS_RANGE / _PR_SCALE[lay["pr"]])
            w.s(lay["pr"], raw)
    if lay["ph"]:
        for ob in present:
            fine_m = ob.phase_range_m - sat_base(ob)
            if not lay["df397"]:
                fine_m = ((fine_m + _MS_RANGE / 2) % _MS_RANGE
                          - _MS_RANGE / 2)
            # integer-cycle alignment: the receiver's accumulated carrier
            # phase starts at an arbitrary count, so remove whole cycles to
            # bring the fine phaserange inside the field span
            # (rtcm.cc set_DF401/set_DF406)
            if ob.wavelength_m > 0.0 and abs(fine_m) > _MSM_PHASE_SPAN_M:
                fine_m -= round(fine_m / ob.wavelength_m) * ob.wavelength_m
            if abs(fine_m) > _MSM_PHASE_SPAN_M:
                raw = _SENT_FINE_PHASE[lay["ph"]]
            else:
                raw = _round(fine_m / _MS_RANGE / _PH_SCALE[lay["ph"]])
            w.s(lay["ph"], raw)
    if lay["lock"]:
        for ob in present:
            if lay["lock"] == 4:
                w.u(4, _df402_msm_lock(ob.lock_time_s))
            else:
                w.u(10, min(_df407_lock(ob.lock_time_s), 1023))
        for ob in present:
            w.u(1, 0)               # half-cycle ambiguity
    if lay["cnr"]:
        for ob in present:
            if lay["cnr"] == 6:
                w.u(6, _round(ob.cn0_dbhz))
            else:
                w.u(10, _round(ob.cn0_dbhz / 0.0625))
    if lay["frate"]:
        for ob in present:
            w.s(15, _round((ob.phase_rate_ms - rough_rate[ob.sat]) / 1e-4))
    return frame(w.to_bytes())


def decode_msm(payload: bytes) -> dict:
    """Decode an MSM1-7 payload back into observation dicts.  MSM1-3
    (no DF397) return pseudorange/phase modulo 1 ms of range — resolved
    with an approximate receiver position, as rtklib does."""
    r = BitReader(payload)
    msgnum = r.u(12)
    base = msgnum - (msgnum % 10)
    msm = msgnum % 10
    lay = _MSM_LAYOUT[msm]
    system = _SYS_BY_BASE[base]
    out = {"msgnum": msgnum, "system": system, "station_id": r.u(12),
           "epoch_ms": r.u(30)}
    if system == "GLONASS":
        # DF416 day of week (3 bits) + DF034 ms of GLONASS day (27 bits)
        out["glonass_dow"] = out["epoch_ms"] >> 27
        out["glonass_tod_ms"] = out["epoch_ms"] & ((1 << 27) - 1)
    r.u(1); r.u(3); r.u(7); r.u(8)
    sats = [i for i in range(1, 65) if r.u(1)]
    sigs = [i for i in range(1, 33) if r.u(1)]
    cells = [(s, g) for s in sats for g in sigs]
    mask = [bool(r.u(1)) for _ in cells]

    rough_int = {s: (r.u(8) if lay["df397"] else 0) for s in sats}
    if lay["rate"]:
        for s in sats:
            r.u(4)
    rough_mod = {s: r.u(10) for s in sats}
    rough_rate = {}
    if lay["rate"]:
        rough_rate = {s: r.s(14) for s in sats}

    present = [c for c, m in zip(cells, mask) if m]
    n = len(present)
    fine_pr = [None] * n
    if lay["pr"]:
        raw = [r.s(lay["pr"]) for _ in range(n)]
        fine_pr = [None if v == _SENT_FINE_PR[lay["pr"]]
                   else v * _PR_SCALE[lay["pr"]] for v in raw]
    fine_ph = [None] * n
    if lay["ph"]:
        raw = [r.s(lay["ph"]) for _ in range(n)]
        fine_ph = [None if v == _SENT_FINE_PHASE[lay["ph"]]
                   else v * _PH_SCALE[lay["ph"]] for v in raw]
    locks = [0] * n
    halfs = [0] * n
    if lay["lock"]:
        locks = [r.u(lay["lock"]) for _ in range(n)]
        halfs = [r.u(1) for _ in range(n)]
    cn0s = [0.0] * n
    if lay["cnr"]:
        cn0s = [r.u(6) * 1.0 if lay["cnr"] == 6 else r.u(10) * 0.0625
                for _ in range(n)]
    rates = [r.s(15) * 1e-4 for _ in range(n)] if lay["frate"] \
        else [0.0] * n

    sig_name = {v: k for k, v in MSM_SIGNAL_ID[system].items()}
    obs = []
    for k, (s, g) in enumerate(present):
        base_m = (rough_int[s] + rough_mod[s] / 1024) * _MS_RANGE
        obs.append({
            "sat": s, "signal": sig_name.get(g, str(g)),
            "pseudorange_m": (base_m + fine_pr[k] * _MS_RANGE)
            if fine_pr[k] is not None else None,
            "phase_range_m": (base_m + fine_ph[k] * _MS_RANGE)
            if fine_ph[k] is not None else None,
            "lock": locks[k], "half_cycle": halfs[k],
            "cn0_dbhz": cn0s[k],
            "phase_rate_ms": (rough_rate.get(s, 0) + rates[k])
            if lay["frate"] else 0.0,
        })
    out["observations"] = obs
    return out


@dataclasses.dataclass
class BaseObs:
    pseudorange_m: float
    carrier_phase_cycles: float


def read_base_observables(stream: bytes, signal: str = "1C"):
    """Decode a concatenated RTCM stream (the CLI's observables.rtcm, or
    any MSM4/7 + MT1005 feed) into base-station data for the RTK/DGNSS
    baseline processors:

        (base_ecef | None, [(tow_s, {prn: BaseObs})]) with BaseObs
    carrying pseudorange_m / carrier_phase_cycles (the epoch-list shape
    pvt.rtk.solve_baseline / pvt.rtk_ekf take as base_epochs)

    Carrier phase is returned in the receiver's integrated-NCO convention
    (-range/lambda; the constant offset is absorbed into the DD
    ambiguities) so the epochs plug straight into pvt.rtk.solve_baseline /
    pvt.rtk_ekf as base_epochs."""
    from ..constants import SIGNALS, SPEED_OF_LIGHT_M_S

    lam = SPEED_OF_LIGHT_M_S / SIGNALS[signal].carrier_freq_hz
    want_sig = signal
    base_ecef = None
    epochs = []
    for msgnum, payload in iter_frames(stream):
        if msgnum in (1005, 1006):
            d = decode_mt1005(payload)
            import numpy as np
            base_ecef = np.asarray(d["ecef_m"], dtype=float)
        elif 1071 <= msgnum <= 1127 and msgnum % 10 in (4, 5, 6, 7):
            d = decode_msm(payload)
            tow = d["epoch_ms"] * 1e-3
            obs = {}
            for o in d["observations"]:
                if o["signal"] != want_sig or o["pseudorange_m"] is None:
                    continue
                ph = (-o["phase_range_m"] / lam
                      if o["phase_range_m"] is not None else 0.0)
                obs[o["sat"]] = BaseObs(o["pseudorange_m"], ph)
            if obs:
                epochs.append((tow, obs))
    return base_ecef, epochs


# --------------------------------------------------------------------------
# TCP broadcast server (rtcm_printer.cc Rtcm::RunServer analogue)
# --------------------------------------------------------------------------

class RtcmTcpServer:
    """Broadcasts RTCM frames to every connected TCP client.

    Reference: the boost::asio server embedded in rtcm.h (Rtcm_Listener /
    Tcp_Internal_Client machinery) started by rtcm_printer.cc when
    `PVT.rtcm_output_file_enabled` / server port is configured.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 2101):
        self._addr = (host, port)
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._running = False

    @property
    def port(self) -> int:
        return self._addr[1]

    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self._addr)
        self._addr = self._sock.getsockname()
        self._sock.listen(4)
        self._sock.settimeout(0.2)
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                self._clients.append(conn)

    def broadcast(self, frame_bytes: bytes) -> None:
        with self._lock:
            alive = []
            for c in self._clients:
                try:
                    c.sendall(frame_bytes)
                    alive.append(c)
                except OSError:
                    c.close()
            self._clients = alive

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)
        with self._lock:
            for c in self._clients:
                c.close()
            self._clients.clear()
        if self._sock:
            self._sock.close()
