"""RRLP assistance-data PDU encoding/decoding in ASN.1 UPER.

Reference parity: the reference embeds asn1c-generated tables for 3GPP
TS 44.031 (src/core/libs/supl/asn-rrlp/, ~81k LoC generated C) and its
SUPL client extracts GPS assistance from RRLP assistanceData components
(supl.c).  This module implements the UNALIGNED PER (X.691) transfer
syntax for exactly that subset, bit-for-bit compatible with a real SLP's
RRLP payloads:

  PDU ::= SEQUENCE { referenceNumber INTEGER (0..7),
                     component RRLP-Component }
  RRLP-Component ::= CHOICE { msrPositionReq(0), msrPositionRsp(1),
                     assistanceData(2), assistanceDataAck(3),
                     protocolError(4), ... }          -- extensible
  AssistanceData ::= SEQUENCE {                       -- extensible, 6 root
      referenceAssistData ... OPTIONAL, msrAssistData ... OPTIONAL,
      systemInfoAssistData ... OPTIONAL, gps-AssistData GPS-AssistData OPT,
      moreAssDataToBeSent ENUMERATED {noMore(0), more(1)} OPTIONAL,
      extensionContainer ... OPTIONAL, ..., rel98/rel5 extensions }
  GPS-AssistData ::= SEQUENCE { controlHeader ControlHeader }
  ControlHeader ::= SEQUENCE { referenceTime?, refLocation?,
      dgpsCorrections?, navigationModel?, ionosphericModel?, utcModel?,
      almanac?, acquisAssist?, realTimeIntegrity? }   -- 9 optional, no ext
  (field widths verified against the generated per-constraints tables:
  asn-rrlp/UncompressedEphemeris.c, IonosphericModel.c, UTCModel.c,
  GPSTime.c, SeqOfNavModelElement.c, SatStatus.c, AcquisElement.c)

Navigation-model integers are the LNAV subframe integers (IS-GPS-200
Table 20-III scales); angles are in SEMICIRCLES at 2^-31 — the same
convention GpsEphemeris stores.
"""

from __future__ import annotations

from ..telemetry.lnav import GpsEphemeris, GpsIono, GpsUtc


class UperWriter:
    def __init__(self):
        self.bits: list[int] = []

    def bit(self, v: int) -> None:
        self.bits.append(1 if v else 0)

    def uint(self, n: int, v: int) -> None:
        """n-bit unsigned field (constrained whole number, value - lb)."""
        v = int(v)
        if not 0 <= v < (1 << n):
            raise ValueError(f"value {v} does not fit in {n} bits")
        self.bits.extend((v >> (n - 1 - k)) & 1 for k in range(n))

    def cint(self, lo: int, hi: int, v: int) -> None:
        """Constrained INTEGER (lo..hi): UPER fixed width ceil(log2(range))."""
        rng = hi - lo + 1
        n = max((rng - 1).bit_length(), 0)
        if not lo <= int(v) <= hi:
            raise ValueError(f"{v} outside ({lo}..{hi})")
        if n:
            self.uint(n, int(v) - lo)

    def octets(self, data: bytes) -> None:
        for b in data:
            self.uint(8, b)

    def tobytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(
            sum(bits[i + k] << (7 - k) for k in range(8))
            for i in range(0, len(bits), 8))


class UperReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bit(self) -> int:
        b = (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def uint(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def cint(self, lo: int, hi: int) -> int:
        rng = hi - lo + 1
        n = max((rng - 1).bit_length(), 0)
        return lo + (self.uint(n) if n else 0)

    def octets(self, n: int) -> bytes:
        return bytes(self.uint(8) for _ in range(n))


# ---- navigation model (UncompressedEphemeris, asn-rrlp field order) ----
# (name on GpsEphemeris | None, lo, hi, LNAV scale)
_UNCOMPRESSED_EPH = [
    ("_code_on_l2", 0, 3, 1),
    ("_ura", 0, 15, 1),
    ("sv_health", 0, 63, 1),
    ("iodc", 0, 1023, 1),
    ("_l2p", 0, 1, 1),
    ("_rsvd1", 0, 8388607, 1),
    ("_rsvd2", 0, 16777215, 1),
    ("_rsvd3", 0, 16777215, 1),
    ("_rsvd4", 0, 65535, 1),
    ("tgd", -128, 127, 2.0 ** -31),
    ("toc", 0, 37799, 2.0 ** 4),
    ("af2", -128, 127, 2.0 ** -55),
    ("af1", -32768, 32767, 2.0 ** -43),
    ("af0", -2097152, 2097151, 2.0 ** -31),
    ("crs", -32768, 32767, 2.0 ** -5),
    ("delta_n", -32768, 32767, 2.0 ** -43),
    ("m0", -(1 << 31), (1 << 31) - 1, 2.0 ** -31),
    ("cuc", -32768, 32767, 2.0 ** -29),
    ("e", 0, (1 << 32) - 1, 2.0 ** -33),
    ("cus", -32768, 32767, 2.0 ** -29),
    ("sqrt_a", 0, (1 << 32) - 1, 2.0 ** -19),
    ("toe", 0, 37799, 2.0 ** 4),
    ("_fit", 0, 1, 1),
    ("_aoda", 0, 31, 1),
    ("cic", -32768, 32767, 2.0 ** -29),
    ("omega0", -(1 << 31), (1 << 31) - 1, 2.0 ** -31),
    ("cis", -32768, 32767, 2.0 ** -29),
    ("i0", -(1 << 31), (1 << 31) - 1, 2.0 ** -31),
    ("crc", -32768, 32767, 2.0 ** -5),
    ("omega", -(1 << 31), (1 << 31) - 1, 2.0 ** -31),
    ("omega_dot", -8388608, 8388607, 2.0 ** -43),
    ("idot", -8192, 8191, 2.0 ** -43),
]

_IONO_FIELDS = [("alpha0", 2.0 ** -30), ("alpha1", 2.0 ** -27),
                ("alpha2", 2.0 ** -24), ("alpha3", 2.0 ** -24),
                ("beta0", 2.0 ** 11), ("beta1", 2.0 ** 14),
                ("beta2", 2.0 ** 16), ("beta3", 2.0 ** 16)]


def _encode_uncompressed_eph(w: UperWriter, e: GpsEphemeris) -> None:
    for name, lo, hi, scale in _UNCOMPRESSED_EPH:
        v = 0 if name.startswith("_") else getattr(e, name)
        q = int(round(float(v) / scale)) if scale != 1 else int(v)
        w.cint(lo, hi, max(lo, min(hi, q)))


def _decode_uncompressed_eph(r: UperReader, prn: int) -> GpsEphemeris:
    e = GpsEphemeris(prn=prn)
    for name, lo, hi, scale in _UNCOMPRESSED_EPH:
        q = r.cint(lo, hi)
        if not name.startswith("_"):
            setattr(e, name, q * scale if scale != 1 else q)
    e.iodc = int(e.iodc)
    e.iode = int(e.iodc) & 0xFF
    e.sv_health = int(e.sv_health)
    return e


def _gad_point_alt(lat_deg: float, lon_deg: float, alt_m: float) -> bytes:
    """GAD shape 'ellipsoid point with altitude' (3GPP TS 23.032 §7.3.2):
    type nibble 8, 23-bit lat (sign+magnitude, 90/2^23 deg) and 24-bit
    two's-complement lon (360/2^24 deg), 15-bit alt with depth sign."""
    lat_q = min(int(round(abs(lat_deg) * (1 << 23) / 90.0)), (1 << 23) - 1)
    if lat_deg < 0:
        lat_q |= 1 << 23
    lon_q = int(round(lon_deg * (1 << 24) / 360.0)) & 0xFFFFFF
    alt_q = min(int(round(abs(alt_m))), (1 << 15) - 1)
    if alt_m < 0:
        alt_q |= 1 << 15
    return bytes([0x80,
                  (lat_q >> 16) & 0xFF, (lat_q >> 8) & 0xFF, lat_q & 0xFF,
                  (lon_q >> 16) & 0xFF, (lon_q >> 8) & 0xFF, lon_q & 0xFF,
                  (alt_q >> 8) & 0xFF, alt_q & 0xFF])


def _gad_parse(data: bytes):
    lat_q = ((data[1] & 0x7F) << 16) | (data[2] << 8) | data[3]
    lat = lat_q * 90.0 / (1 << 23)
    if data[1] & 0x80:
        lat = -lat
    lon_q = (data[4] << 16) | (data[5] << 8) | data[6]
    if lon_q >= 1 << 23:
        lon_q -= 1 << 24
    lon = lon_q * 360.0 / (1 << 24)
    alt = 0.0
    if len(data) >= 9:
        alt_q = ((data[7] & 0x7F) << 8) | data[8]
        alt = -float(alt_q) if data[7] & 0x80 else float(alt_q)
    return lat, lon, alt


def encode_assistance_pdu(assist, reference_number: int = 1) -> bytes:
    """SuplAssist -> RRLP PDU (assistanceData component) in UPER."""
    w = UperWriter()
    w.cint(0, 7, reference_number)            # PDU.referenceNumber
    w.bit(0)                                  # RRLP-Component: not extended
    w.uint(3, 2)                              # choice index: assistanceData
    w.bit(0)                                  # AssistanceData: no extensions
    # 6 root optionals: referenceAssistData, msrAssistData,
    # systemInfoAssistData, gps-AssistData, moreAssDataToBeSent,
    # extensionContainer
    w.bit(0)
    w.bit(0)
    w.bit(0)
    w.bit(1)                                  # gps-AssistData present
    w.bit(0)
    w.bit(0)
    # GPS-AssistData ::= SEQUENCE { controlHeader } — no opts/ext
    has_ref_time = assist.ref_time_week >= 0
    has_nav = bool(assist.ephemerides)
    has_acq = bool(assist.acq_assist)
    # ControlHeader 9-bit optional bitmap
    for present in (has_ref_time, assist.has_ref_location, False, has_nav,
                    assist.iono is not None, assist.utc is not None,
                    False, has_acq, False):
        w.bit(present)
    if has_ref_time:
        # ReferenceTime: opts gsmTime, gpsTowAssist absent
        w.bit(0)
        w.bit(0)
        # GPSTime: gpsTOW23b (80 ms units), gpsWeek
        w.cint(0, 7559999, int(round(assist.ref_time_tow_s / 0.08)))
        w.cint(0, 1023, int(assist.ref_time_week) & 0x3FF)
    if assist.has_ref_location:
        gad = _gad_point_alt(assist.ref_lat_deg, assist.ref_lon_deg,
                             assist.ref_alt_m)
        w.cint(1, 20, len(gad))               # Ext-GeographicalInformation
        w.octets(gad)
    if has_nav:
        # NavigationModel ::= SEQUENCE { navModelList SIZE(1..16) }
        prns = sorted(assist.ephemerides)[:16]
        w.cint(1, 16, len(prns))
        for prn in prns:
            w.cint(0, 63, prn - 1)            # SatelliteID = PRN - 1
            w.bit(0)                          # SatStatus: not extended
            w.uint(2, 0)                      # newSatelliteAndModelUC
            _encode_uncompressed_eph(w, assist.ephemerides[prn])
    if assist.iono is not None:
        for name, sc in _IONO_FIELDS:
            w.cint(-128, 127, int(round(getattr(assist.iono, name) / sc)))
    if assist.utc is not None:
        u = assist.utc
        w.cint(-8388608, 8388607, int(round(u.a1 / 2.0 ** -50)))
        w.cint(-(1 << 31), (1 << 31) - 1, int(round(u.a0 / 2.0 ** -30)))
        w.cint(0, 255, int(u.tot) >> 12)
        w.cint(0, 255, int(u.wn_t) & 0xFF)
        w.cint(-128, 127, int(u.delta_t_ls))
        w.cint(0, 255, int(u.wn_lsf) & 0xFF)
        w.cint(-128, 127, int(u.dn))
        w.cint(-128, 127, int(u.delta_t_lsf))
    if has_acq:
        # AcquisAssist ::= SEQUENCE { timeRelation, acquisList SIZE(1..16) }
        w.bit(0)                              # TimeRelation: gsmTime absent
        w.cint(0, 7559999,
               int(round(max(assist.ref_time_tow_s, 0.0) / 0.08)))
        prns = sorted(assist.acq_assist)[:16]
        w.cint(1, 16, len(prns))
        for prn in prns:
            q = assist.acq_assist[prn]
            # AcquisElement: 2 optionals (addionalDoppler, addionalAngle)
            w.bit(1)
            w.bit(1)
            w.cint(0, 63, prn - 1)            # svid
            w.cint(-2048, 2047, int(round(q.doppler0_hz / 2.5)))
            # AddionalDopplerFields: doppler1 in 1/42 Hz/s from -1.0
            w.cint(0, 63, max(0, min(63, int(round(
                (q.doppler1_hz_s + 1.0) * 42.0)))))
            w.cint(0, 7, 4)                   # dopplerUncertainty
            w.cint(0, 1022, int(q.code_phase_chips) % 1023)
            w.cint(0, 19, int(q.code_phase_int_ms) % 20)
            w.cint(0, 3, (int(q.code_phase_int_ms) // 20) % 4)
            w.cint(0, 15, 2)                  # codePhaseSearchWindow
            # AddionalAngleFields: 11.25-degree sectors
            w.cint(0, 31, int(q.azimuth_deg / 11.25) % 32)
            w.cint(0, 7, max(0, min(7, int(q.elevation_deg / 11.25))))
    return w.tobytes()


def decode_assistance_pdu(data: bytes):
    """RRLP PDU bytes -> SuplAssist (GPS assistance subset)."""
    from .supl import SuplAssist

    r = UperReader(data)
    a = SuplAssist()
    r.cint(0, 7)                              # referenceNumber
    if r.bit():
        raise ValueError("extended RRLP-Component not supported")
    idx = r.uint(3)
    if idx != 2:
        raise ValueError(f"not an assistanceData component (choice {idx})")
    if r.bit():
        raise ValueError("extended AssistanceData not supported")
    opts = [r.bit() for _ in range(6)]
    if opts[0] or opts[1] or opts[2]:
        raise ValueError("E-OTD assistance elements not supported")
    if not opts[3]:
        return a                              # no gps-AssistData
    hdr = [r.bit() for _ in range(9)]
    (has_rt, has_loc, has_dgps, has_nav, has_iono, has_utc,
     has_alm, has_acq, has_rti) = hdr
    if has_dgps or has_alm or has_rti:
        raise ValueError("unsupported ControlHeader elements present")
    if has_rt:
        if r.bit() or r.bit():
            raise ValueError("gsmTime/gpsTowAssist not supported")
        a.ref_time_tow_s = r.cint(0, 7559999) * 0.08
        a.ref_time_week = r.cint(0, 1023)
    if has_loc:
        n = r.cint(1, 20)
        gad = r.octets(n)
        a.ref_lat_deg, a.ref_lon_deg, a.ref_alt_m = _gad_parse(gad)
        a.has_ref_location = True
    if has_nav:
        n = r.cint(1, 16)
        for _ in range(n):
            sat_id = r.cint(0, 63)
            if r.bit():
                raise ValueError("extended SatStatus not supported")
            st = r.uint(2)
            if st == 1:                       # oldSatelliteAndModel: NULL
                continue
            e = _decode_uncompressed_eph(r, sat_id + 1)
            if a.ref_time_week >= 0:
                # restore the full week number near the reference week
                e.week = int(a.ref_time_week)
            a.ephemerides[sat_id + 1] = e
    if has_iono:
        vals = [r.cint(-128, 127) * sc for _, sc in _IONO_FIELDS]
        a.iono = GpsIono(*vals, valid=True)
    if has_utc:
        a1 = r.cint(-8388608, 8388607) * 2.0 ** -50
        a0 = r.cint(-(1 << 31), (1 << 31) - 1) * 2.0 ** -30
        tot = r.cint(0, 255) << 12
        wn_t = r.cint(0, 255)
        dtls = r.cint(-128, 127)
        wn_lsf = r.cint(0, 255)
        dn = r.cint(-128, 127)
        dtlsf = r.cint(-128, 127)
        a.utc = GpsUtc(a0=a0, a1=a1, tot=float(tot), wn_t=wn_t,
                       delta_t_ls=dtls, wn_lsf=wn_lsf, dn=dn,
                       delta_t_lsf=dtlsf, valid=True)
    if has_acq:
        from .supl import AcqAssist

        if r.bit():
            raise ValueError("TimeRelation gsmTime not supported")
        tow = r.cint(0, 7559999) * 0.08
        if a.ref_time_week < 0:
            a.ref_time_tow_s = tow
        n = r.cint(1, 16)
        for _ in range(n):
            has_dop1 = r.bit()
            has_angle = r.bit()
            svid = r.cint(0, 63)
            q = AcqAssist(prn=svid + 1)
            q.doppler0_hz = r.cint(-2048, 2047) * 2.5
            if has_dop1:
                q.doppler1_hz_s = r.cint(0, 63) / 42.0 - 1.0
                r.cint(0, 7)                  # dopplerUncertainty
            q.code_phase_chips = float(r.cint(0, 1022))
            int_ms = r.cint(0, 19)
            bitno = r.cint(0, 3)
            q.code_phase_int_ms = bitno * 20 + int_ms
            r.cint(0, 15)                     # codePhaseSearchWindow
            if has_angle:
                q.azimuth_deg = r.cint(0, 31) * 11.25
                q.elevation_deg = r.cint(0, 7) * 11.25
            a.acq_assist[svid + 1] = q
        return a
    return a
