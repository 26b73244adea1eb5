"""SUPL 1.0 A-GNSS client + assistance server (TCP).

Reference parity: gnss_sdr_supl_client.{h,cc} + supl/supl.c — the
reference's SET client opens a TCP(/TLS) session to an SLP server
(default port 7275), walks the SUPL session (START -> RESPONSE ->
POS INIT -> POS -> END) and extracts the RRLP-delivered assistance:
ephemeris map, iono, UTC model, reference time/location and acquisition
assistance (supl_assist_t, supl.h).  ControlThread::assist_GNSS
(control_thread.cc:566-740) drives it via the GNSS-SDR.SUPL_* properties.

This implementation speaks the same session flow over the same framing
(every ULP PDU is length-prefixed with version 1.0.0 and session ids) and
delivers the same assistance sets, with the navigation-model payload
packed at the broadcast LNAV integer quantization exactly as RRLP carries
it (3GPP TS 44.031 navigation-model fields ARE the subframe integers).
The POS payload body is a REAL RRLP assistanceData PDU in ASN.1 UPER
(runtime.rrlp — hand-built against the TS 44.031 field tables the
reference's asn1c-generated code embeds), so the navigation-model/
assistance bytes are what a real SLP's RRLP payload carries; SuplServer
serves a receiver's decoded ephemerides to other receivers, the
self-hosted analogue of an SLP.  encode_assist/decode_assist remain as
the compact internal serialization used by the assistance store.

Zero-egress environments: everything is loopback-testable
(tests/test_supl.py).
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading

import numpy as np

from ..telemetry.lnav import GpsEphemeris, GpsIono, GpsUtc

SUPL_PORT = 7275

# message types (ULP-Message choice tags)
MSG_START, MSG_RESPONSE, MSG_POS_INIT, MSG_POS, MSG_END = 1, 2, 3, 4, 5


# ----------------------------------------------------------------------
# bit-level packing
# ----------------------------------------------------------------------

class _W:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, n, v):
        v = int(v) & ((1 << n) - 1)
        self.bits.extend((v >> (n - 1 - k)) & 1 for k in range(n))

    def s(self, n, v):
        self.u(n, int(v) & ((1 << n) - 1))

    def sf(self, n, scale, v):
        """Signed scaled float -> n-bit two's complement."""
        self.s(n, int(round(v / scale)))

    def uf(self, n, scale, v):
        self.u(n, int(round(v / scale)))

    def bytes(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(
            sum(bit << (7 - j) for j, bit in enumerate(b[i:i + 8]))
            for i in range(0, len(b), 8))


class _R:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def u(self, n) -> int:
        v = 0
        for _ in range(n):
            byte = self.d[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def s(self, n) -> int:
        v = self.u(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def sf(self, n, scale) -> float:
        return self.s(n) * scale

    def uf(self, n, scale) -> float:
        return self.u(n) * scale


# LNAV/RRLP navigation-model quantization (IS-GPS-200 Table 20-III —
# identical widths/scales to RRLP NavModelElement)
_EPH_FIELDS = [
    ("week", 10, 1, False), ("iodc", 10, 1, False), ("iode", 8, 1, False),
    ("sv_health", 6, 1, False),
    ("toc", 16, 2.0 ** 4, False), ("toe", 16, 2.0 ** 4, False),
    ("af0", 22, 2.0 ** -31, True), ("af1", 16, 2.0 ** -43, True),
    ("af2", 8, 2.0 ** -55, True), ("tgd", 8, 2.0 ** -31, True),
    ("sqrt_a", 32, 2.0 ** -19, False), ("e", 32, 2.0 ** -33, False),
    ("m0", 32, 2.0 ** -31, True), ("delta_n", 16, 2.0 ** -43, True),
    ("omega0", 32, 2.0 ** -31, True), ("i0", 32, 2.0 ** -31, True),
    ("omega", 32, 2.0 ** -31, True), ("omega_dot", 24, 2.0 ** -43, True),
    ("idot", 14, 2.0 ** -43, True),
    ("cuc", 16, 2.0 ** -29, True), ("cus", 16, 2.0 ** -29, True),
    ("crc", 16, 2.0 ** -5, True), ("crs", 16, 2.0 ** -5, True),
    ("cic", 16, 2.0 ** -29, True), ("cis", 16, 2.0 ** -29, True),
]


@dataclasses.dataclass
class AcqAssist:
    """Per-satellite acquisition assistance (supl.h struct supl_acq_t /
    Gps_Acq_Assist): expected Doppler and code phase at the reference
    time."""

    prn: int = 0
    doppler0_hz: float = 0.0
    doppler1_hz_s: float = 0.0
    code_phase_chips: float = 0.0
    code_phase_int_ms: int = 0
    azimuth_deg: float = 0.0
    elevation_deg: float = 0.0


@dataclasses.dataclass
class SuplAssist:
    """The assistance bundle a SUPL POS delivers (supl_assist_t)."""

    ref_time_week: int = -1
    ref_time_tow_s: float = -1.0
    ref_lat_deg: float = 0.0
    ref_lon_deg: float = 0.0
    ref_alt_m: float = 0.0
    has_ref_location: bool = False
    ephemerides: dict = dataclasses.field(default_factory=dict)
    iono: GpsIono | None = None
    utc: GpsUtc | None = None
    acq_assist: dict = dataclasses.field(default_factory=dict)


def encode_assist(a: SuplAssist) -> bytes:
    w = _W()
    w.u(1, a.ref_time_week >= 0)
    if a.ref_time_week >= 0:
        w.u(16, a.ref_time_week)
        w.uf(27, 0.01, a.ref_time_tow_s)      # 10 ms resolution, <=604800 s
    w.u(1, a.has_ref_location)
    if a.has_ref_location:
        # RRLP ellipsoid point with altitude: 24-bit lat/lon, 15-bit alt
        w.sf(24, 90.0 / (1 << 23), a.ref_lat_deg)
        w.sf(24, 180.0 / (1 << 23), a.ref_lon_deg)
        w.sf(15, 1.0, a.ref_alt_m)
    w.u(1, a.iono is not None)
    if a.iono is not None:
        for name, sc in (("alpha0", 2.0 ** -30), ("alpha1", 2.0 ** -27),
                         ("alpha2", 2.0 ** -24), ("alpha3", 2.0 ** -24),
                         ("beta0", 2.0 ** 11), ("beta1", 2.0 ** 14),
                         ("beta2", 2.0 ** 16), ("beta3", 2.0 ** 16)):
            w.sf(8, sc, getattr(a.iono, name))
    w.u(1, a.utc is not None)
    if a.utc is not None:
        u = a.utc
        w.sf(32, 2.0 ** -30, u.a0)
        w.sf(24, 2.0 ** -50, u.a1)
        w.uf(8, 2.0 ** 12, u.tot)
        w.u(8, u.wn_t)
        w.s(8, u.delta_t_ls)
        w.u(8, u.wn_lsf)
        w.u(8, u.dn)
        w.s(8, u.delta_t_lsf)
    w.u(6, len(a.ephemerides))
    for prn in sorted(a.ephemerides):
        e = a.ephemerides[prn]
        w.u(6, prn)
        for name, n, sc, signed in _EPH_FIELDS:
            (w.sf if signed else w.uf)(n, sc, getattr(e, name))
    w.u(6, len(a.acq_assist))
    for prn in sorted(a.acq_assist):
        q = a.acq_assist[prn]
        w.u(6, prn)
        w.sf(16, 2.5, q.doppler0_hz)          # RRLP doppler0: 2.5 Hz LSB
        w.sf(8, 1.0 / 42.0, q.doppler1_hz_s)
        w.uf(16, 2.0 ** -10, q.code_phase_chips / 1023.0)
        w.u(7, q.code_phase_int_ms)
        w.uf(9, 1.0, q.azimuth_deg)
        w.uf(8, 1.0, q.elevation_deg)
    return w.bytes()


def decode_assist(data: bytes) -> SuplAssist:
    r = _R(data)
    a = SuplAssist()
    if r.u(1):
        a.ref_time_week = r.u(16)
        a.ref_time_tow_s = r.uf(27, 0.01)
    a.has_ref_location = bool(r.u(1))
    if a.has_ref_location:
        a.ref_lat_deg = r.sf(24, 90.0 / (1 << 23))
        a.ref_lon_deg = r.sf(24, 180.0 / (1 << 23))
        a.ref_alt_m = r.sf(15, 1.0)
    if r.u(1):
        vals = [r.sf(8, sc) for sc in (2.0 ** -30, 2.0 ** -27, 2.0 ** -24,
                                       2.0 ** -24, 2.0 ** 11, 2.0 ** 14,
                                       2.0 ** 16, 2.0 ** 16)]
        a.iono = GpsIono(*vals, valid=True)
    if r.u(1):
        a.utc = GpsUtc(a0=r.sf(32, 2.0 ** -30), a1=r.sf(24, 2.0 ** -50),
                       tot=r.uf(8, 2.0 ** 12), wn_t=r.u(8),
                       delta_t_ls=r.s(8), wn_lsf=r.u(8), dn=r.u(8),
                       delta_t_lsf=r.s(8), valid=True)
    for _ in range(r.u(6)):
        prn = r.u(6)
        e = GpsEphemeris(prn=prn)
        for name, n, sc, signed in _EPH_FIELDS:
            setattr(e, name, (r.sf if signed else r.uf)(n, sc))
        e.week = int(e.week)
        e.iodc = int(e.iodc)
        e.iode = int(e.iode)
        e.sv_health = int(e.sv_health)
        a.ephemerides[prn] = e
    for _ in range(r.u(6)):
        prn = r.u(6)
        q = AcqAssist(prn=prn)
        q.doppler0_hz = r.sf(16, 2.5)
        q.doppler1_hz_s = r.sf(8, 1.0 / 42.0)
        q.code_phase_chips = r.uf(16, 2.0 ** -10) * 1023.0
        q.code_phase_int_ms = r.u(7)
        q.azimuth_deg = r.uf(9, 1.0)
        q.elevation_deg = r.uf(8, 1.0)
        a.acq_assist[prn] = q
    return a


# ----------------------------------------------------------------------
# ULP framing + session
# ----------------------------------------------------------------------

def _pdu(msg_type: int, session: bytes, payload: bytes = b"") -> bytes:
    """ULP PDU: u16 total length | version 1.0.0 | 8-byte session |
    u8 message type | payload."""
    body = bytes([1, 0, 0]) + session + bytes([msg_type]) + payload
    return struct.pack(">H", len(body) + 2) + body


def _read_pdu(sock) -> tuple[int, bytes, bytes]:
    hdr = _recvn(sock, 2)
    (ln,) = struct.unpack(">H", hdr)
    body = _recvn(sock, ln - 2)
    if body[:3] != bytes([1, 0, 0]):
        raise ValueError(f"SUPL version mismatch: {body[:3].hex()}")
    return body[11], body[3:11], body[12:]


def _recvn(sock, n) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("SUPL peer closed")
        out += chunk
    return out


class SuplClient:
    """SET-side client (Gnss_Sdr_Supl_Client analogue).

    After get_assistance(): gps_ephemeris_map / gps_iono / gps_utc /
    gps_time / gps_ref_loc / gps_acq_map mirror the reference members."""

    def __init__(self, server_name: str = "127.0.0.1",
                 server_port: int = SUPL_PORT, request: int = 0):
        self.server_name = server_name
        self.server_port = server_port
        self.request = request
        self.gps_ephemeris_map: dict[int, GpsEphemeris] = {}
        self.gps_iono = GpsIono()
        self.gps_utc = GpsUtc()
        self.gps_time: tuple[int, float] | None = None
        self.gps_ref_loc: tuple[float, float, float] | None = None
        self.gps_acq_map: dict[int, AcqAssist] = {}

    def get_assistance(self, mcc: int = 244, mns: int = 5,
                       lac: int = 0x59E2, ci: int = 0x31B0) -> int:
        """Run one SUPL session; returns 0 on success (reference
        signature, gnss_sdr_supl_client.h:115 — the GSM cell identifiers
        form the locationId of SUPL START)."""
        try:
            with socket.create_connection(
                    (self.server_name, self.server_port), timeout=10) as s:
                session = struct.pack(">HHHH", mcc, mns, lac, ci)
                s.sendall(_pdu(MSG_START, session,
                               struct.pack(">B", self.request)))
                t, sess, _ = _read_pdu(s)
                if t != MSG_RESPONSE:
                    return -2
                # POS INIT: request assistance sets (all, like supl.c's
                # request mask)
                s.sendall(_pdu(MSG_POS_INIT, sess,
                               struct.pack(">B", 0xFF)))
                t, _, payload = _read_pdu(s)
                if t != MSG_POS:
                    return -3
                # POS payload is a real RRLP assistanceData PDU in ASN.1
                # UPER (runtime.rrlp; TS 44.031) — the wire format a real
                # SLP's RRLP positioning payload uses
                from .rrlp import decode_assistance_pdu
                self.read_supl_data(decode_assistance_pdu(payload))
                s.sendall(_pdu(MSG_END, sess))
                return 0
        except (OSError, ValueError, ConnectionError):
            return -1

    def read_supl_data(self, a: SuplAssist) -> None:
        self.gps_ephemeris_map = dict(a.ephemerides)
        if a.iono is not None:
            self.gps_iono = a.iono
        if a.utc is not None:
            self.gps_utc = a.utc
        if a.ref_time_week >= 0:
            self.gps_time = (a.ref_time_week, a.ref_time_tow_s)
        if a.has_ref_location:
            self.gps_ref_loc = (a.ref_lat_deg, a.ref_lon_deg, a.ref_alt_m)
        self.gps_acq_map = dict(a.acq_assist)


class SuplServer:
    """SLP-side assistance server: serves a SuplAssist bundle (e.g. a
    running receiver's decoded ephemerides) to SET clients — the
    self-hosted analogue of the reference's external SLP."""

    def __init__(self, assist: SuplAssist, host: str = "127.0.0.1",
                 port: int = 0):
        self.assist = assist
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._session, args=(conn,),
                             daemon=True).start()

    def _session(self, conn):
        try:
            with conn:
                conn.settimeout(10)
                t, sess, _ = _read_pdu(conn)
                if t != MSG_START:
                    return
                conn.sendall(_pdu(MSG_RESPONSE, sess))
                t, _, _ = _read_pdu(conn)
                if t != MSG_POS_INIT:
                    return
                from .rrlp import encode_assistance_pdu
                conn.sendall(_pdu(MSG_POS, sess,
                                  encode_assistance_pdu(self.assist)))
                try:
                    _read_pdu(conn)          # SUPL END
                except (ConnectionError, ValueError):
                    pass
        except (OSError, ValueError, ConnectionError):
            pass

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2)
