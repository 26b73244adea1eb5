"""PVT output formats: RINEX observation/navigation, NMEA, KML, GPX, GeoJSON.

Reference parity: src/algorithms/PVT/libs/rinex_printer.cc (RINEX 3.02
multi-constellation obs + nav: GPS LNAV/CNAV, Galileo I/NAV, BeiDou D1,
GLONASS GNAV state vectors — rinex_printer.cc:850 obs headers, :964 nav
headers with iono/UTC corrections, :1186 per-system records; the legacy
RINEX 2.11 writers selected by `PVT.rinex_version=2`, rinex_printer.cc:106
`d_version` and the `version == 2` branches of rinex_obs_header /
log_rinex_obs / rinex_nav_header), nmea_printer.cc (GPGGA/GPRMC),
kml_printer.cc, gpx_printer.cc, geojson_printer.cc.

All RINEX writers take `version` (3 -> 3.02, 2 -> 2.11); 2.11 uses the
two-character observation codes, the single shared `# / TYPES OF OBSERV`
list, `yy`-style epoch lines with the A1I2 satellite roster, and the
GPS-only `N: GPS NAV DATA` broadcast format.
"""

from __future__ import annotations

import datetime
import io
from typing import Iterable

import numpy as np

from ..telemetry.lnav import GpsEphemeris
from .solver import PvtSolution

_GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)


def gps_time_to_utc(week: int, tow_s: float, leap_s: int = 18) -> datetime.datetime:
    return _GPS_EPOCH + datetime.timedelta(
        weeks=week, seconds=tow_s - leap_s
    )


# ---------------------------------------------------------------- RINEX ----

def _rnx(x: float, width: int = 19, dec: int = 12) -> str:
    """RINEX D-format float."""
    s = f"{x:.{dec}E}"
    mant, _, exp = s.partition("E")
    return f"{mant}D{int(exp):+03d}".rjust(width)


# obs codes per signal id (RINEX 3.02 Table A2 / rinex_printer.cc obs-type
# selection): 4 observables (code, phase, doppler, CN0) per tracked signal
_OBS_CODES = {
    "1C": ("G", ("C1C", "L1C", "D1C", "S1C")),
    "2S": ("G", ("C2S", "L2S", "D2S", "S2S")),
    "L5": ("G", ("C5I", "L5I", "D5I", "S5I")),
    "1B": ("E", ("C1B", "L1B", "D1B", "S1B")),
    "5X": ("E", ("C5I", "L5I", "D5I", "S5I")),
    "1G": ("R", ("C1C", "L1C", "D1C", "S1C")),
    "2G": ("R", ("C2C", "L2C", "D2C", "S2C")),
    "B1": ("C", ("C2I", "L2I", "D2I", "S2I")),
    "B3": ("C", ("C6I", "L6I", "D6I", "S6I")),
}


def _v2_obs_types(signals: tuple[str, ...]) -> list[str]:
    """RINEX 2.11 two-character observation codes: one shared list for
    every system in the file (spec Table A1; rinex_printer.cc version==2
    obs-type branch).  Derived from the 3.02 codes by dropping the
    attribute character, de-duplicated in first-seen order."""
    seen: list[str] = []
    for sig in signals:
        for code in _OBS_CODES[sig][1]:
            c2 = code[:2]
            if c2 not in seen:
                seen.append(c2)
    return seen


def rinex_obs_header(marker: str = "GNSS_SDR_1_TPU",
                     approx_xyz: np.ndarray | None = None,
                     signals: tuple[str, ...] = ("1C",),
                     glonass_slots: dict[int, int] | None = None,
                     version: int = 3,
                     time_first_obs: datetime.datetime | None = None,
                     interval_s: float | None = None) -> str:
    """RINEX observation header.  version=3 -> 3.02 with per-system
    SYS / # / OBS TYPES lines and GLONASS SLOT/FRQ numbers
    (rinex_printer.cc:850); version=2 -> 2.11 with the shared
    `# / TYPES OF OBSERV` list (9 codes per line).  `time_first_obs` /
    `interval_s` emit the mandatory TIME OF FIRST OBS and the INTERVAL
    records (rinex_printer.cc:4306,4325); the GLONASS SLOT / FRQ # record
    exists only in version 3 (rinex_printer.cc:4329 'Only version 3')."""
    out = io.StringIO()
    if version == 2:
        out.write(f"{'2.11':>9}{'':11}{'OBSERVATION DATA':<20}"
                  f"{'M (MIXED)':<20}RINEX VERSION / TYPE\n")
    else:
        out.write(f"{'3.02':>9}{'':11}{'OBSERVATION DATA':<20}{'M: MIXED':<20}"
                  "RINEX VERSION / TYPE\n")
    out.write(f"{'gnss-sdr-1-tpu':<20}{'':40}PGM / RUN BY / DATE\n")
    out.write(f"{marker:<60}MARKER NAME\n")
    if approx_xyz is not None:
        out.write(f"{approx_xyz[0]:14.4f}{approx_xyz[1]:14.4f}"
                  f"{approx_xyz[2]:14.4f}{'':18}APPROX POSITION XYZ\n")
    if version == 2:
        codes = _v2_obs_types(signals)
        for i in range(0, len(codes), 9):
            chunk = codes[i:i + 9]
            head = f"{len(codes):6d}" if i == 0 else " " * 6
            body = "".join(f"{c:>6}" for c in chunk)
            out.write(f"{head}{body:<54}# / TYPES OF OBSERV\n")
    else:
        by_sys: dict[str, list[str]] = {}
        for sig in signals:
            sysl, codes = _OBS_CODES[sig]
            by_sys.setdefault(sysl, []).extend(codes)
        for sysl in sorted(by_sys):
            codes = by_sys[sysl]
            body = " ".join(codes)
            # A1, 2X, I3, 13(1X, A3) — RINEX 3.02 Table A5 (the round-4
            # self-round-trip couldn't see this column; caught by the
            # spec-based layout validator, tests/test_rinex_format.py)
            out.write(f"{sysl}  {len(codes):3d} {body:<53}"
                      "SYS / # / OBS TYPES\n")
    if interval_s is not None:
        out.write(f"{interval_s:10.3f}{'':50}INTERVAL\n")
    if time_first_obs is not None:
        t = time_first_obs
        out.write(f"{t.year:6d}{t.month:6d}{t.day:6d}{t.hour:6d}"
                  f"{t.minute:6d}{t.second + t.microsecond / 1e6:13.7f}"
                  f"{'':5}{'GPS':<3}{'':9}TIME OF FIRST OBS\n")
    if glonass_slots and version != 2:
        ents = "".join(f" R{s:02d} {k:2d}" for s, k in
                       sorted(glonass_slots.items()))
        out.write(f"{len(glonass_slots):3d}{ents:<57}GLONASS SLOT / FRQ #\n")
    out.write(f"{'':60}END OF HEADER\n")
    return out.getvalue()


_OBS_FIELD_OF_CODE_POS = (
    "pseudorange_m", "carrier_phase_cycles", "doppler_hz", "cn0_dbhz")


def _ssi(cn0: float | None) -> str:
    """RINEX signal-strength indicator: quantized C/N0 1-9 (the reference's
    signalStrength(), floor(CN0/6) clamped)."""
    if not cn0:
        return " "
    return str(min(max(int(cn0 // 6.0), 1), 9))


def _obs_field(value: float | None, lli: int = 0, ssi: str = " ") -> str:
    """One F14.3,I1,I1 observation field; None -> 16 blanks."""
    if value is None:
        return " " * 16
    return f"{value:14.3f}{lli if lli else ' '}{ssi}"


def rinex_obs_epoch(week: int, tow_s: float,
                    observations: dict[int, dict],
                    signal: str = "1C", version: int = 3,
                    signals: tuple[str, ...] | None = None) -> str:
    """One observation epoch.  observations: prn -> {pseudorange_m,
    carrier_phase_cycles, doppler_hz, cn0_dbhz, lli}; the satellite letter
    comes from `signal` (multi-signal epochs: pass keys ('1B', prn) etc.).
    version=2 writes the 2.11 epoch line (yy + A1I2 satellite roster, 12 per
    line) followed by per-satellite observation lines whose columns follow
    the `signals` declared # / TYPES OF OBSERV order (blank 16-char fields
    for observables a satellite lacks; 5 observations per line).  The SSI
    column carries the quantized C/N0 digit and the LLI column the
    loss-of-lock flag, as the reference's obs lines do."""
    t = gps_time_to_utc(week, tow_s)
    out = io.StringIO()
    keys = sorted(observations,
                  key=lambda k: (k[0], k[1]) if isinstance(k, tuple)
                  else (signal, k))
    if version == 2:
        if signals is None:
            sigs = []
            for key in keys:
                sig = key[0] if isinstance(key, tuple) else signal
                if sig not in sigs:
                    sigs.append(sig)
            signals = tuple(sigs) or (signal,)
        declared = _v2_obs_types(signals)
        # group per physical satellite: (sys letter, prn) -> {c2: (val, o)}
        sat_obs: dict[tuple[str, int], dict[str, tuple[float, dict]]] = {}
        for key in keys:
            sig, prn = key if isinstance(key, tuple) else (signal, key)
            o = observations[key]
            ent = sat_obs.setdefault((_OBS_CODES[sig][0], prn), {})
            for pos, code in enumerate(_OBS_CODES[sig][1]):
                val = o.get(_OBS_FIELD_OF_CODE_POS[pos])
                if val is not None:
                    ent[code[:2]] = (float(val), o)
        sats = [f"{s}{p:02d}" for s, p in sat_obs]
        head = (f" {t.year % 100:02d} {t.month:2d} {t.day:2d} {t.hour:2d} "
                f"{t.minute:2d}{t.second + t.microsecond/1e6:11.7f}  0"
                f"{len(sats):3d}")
        out.write(head + "".join(sats[:12]) + "\n")
        for i in range(12, len(sats), 12):
            out.write(" " * 32 + "".join(sats[i:i + 12]) + "\n")
        for ent in sat_obs.values():
            fields = []
            for c2 in declared:
                if c2 in ent:
                    val, o = ent[c2]
                    lli = int(o.get("lli", 0)) if c2[0] == "L" else 0
                    ssi = _ssi(o.get("cn0_dbhz")) if c2[0] in "CL" else " "
                    fields.append(_obs_field(val, lli, ssi))
                else:
                    fields.append(_obs_field(None))
            for i in range(0, len(fields), 5):
                out.write("".join(fields[i:i + 5]).rstrip() + "\n")
        return out.getvalue()
    out.write(f"> {t.year:4d} {t.month:02d} {t.day:02d} {t.hour:02d} "
              f"{t.minute:02d}{t.second + t.microsecond/1e6:11.7f}  0"
              f"{len(observations):3d}\n")
    for key in keys:
        sig, prn = key if isinstance(key, tuple) else (signal, key)
        sysl = _OBS_CODES[sig][0]
        o = observations[key]
        ssi = _ssi(o.get("cn0_dbhz"))
        lli = int(o.get("lli", 0))
        out.write(
            f"{sysl}{prn:02d}"
            + _obs_field(o.get("pseudorange_m", 0.0), 0, ssi)
            + _obs_field(o.get("carrier_phase_cycles", 0.0), lli, ssi)
            + _obs_field(o.get("doppler_hz", 0.0))
            + _obs_field(o.get("cn0_dbhz", 0.0)).rstrip() + "\n")
    return out.getvalue()


def _d12(x: float) -> str:
    """2.11 ION ALPHA/BETA D12.4 field."""
    s = f"{float(x):.4E}"
    mant, _, exp = s.partition("E")
    return f"{mant}D{int(exp):+03d}".rjust(12)


def rinex_nav_header(iono=None, leap_s: int = 18, version: int = 3,
                     system: str = "G") -> str:
    """Nav header with Klobuchar iono corrections when available.
    version=3 -> mixed-GNSS 3.02 (rinex_printer.cc:964 IONOSPHERIC CORR /
    LEAP SECONDS); version=2 -> per-system 2.11 file types: system='G'
    GPS nav ('N: GPS NAV DATA'), system='R' GLONASS nav ('G: GLONASS NAV
    DATA', the reference's rinex_nav_header(glonass_gnav_ephemeris)
    version-2 branch)."""
    out = io.StringIO()
    if version == 2:
        ftype = ("G: GLONASS NAV DATA" if system == "R"
                 else "N: GPS NAV DATA")
        out.write(f"{'2.11':>9}{'':11}{ftype:<20}{'':20}"
                  "RINEX VERSION / TYPE\n")
        out.write(f"{'gnss-sdr-1-tpu':<20}{'':40}PGM / RUN BY / DATE\n")
        if system != "R" and iono is not None and getattr(iono, "valid", False):
            a = "".join(_d12(getattr(iono, f"alpha{k}")) for k in range(4))
            b = "".join(_d12(getattr(iono, f"beta{k}")) for k in range(4))
            out.write(f"{'':2}{a:<58}ION ALPHA\n")
            out.write(f"{'':2}{b:<58}ION BETA\n")
        if system != "R":
            out.write(f"{leap_s:6d}{'':54}LEAP SECONDS\n")
        out.write(f"{'':60}END OF HEADER\n")
        return out.getvalue()
    out.write(f"{'3.02':>9}{'':11}{'N: GNSS NAV DATA':<20}{'M: MIXED':<20}"
              "RINEX VERSION / TYPE\n")
    out.write(f"{'gnss-sdr-1-tpu':<20}{'':40}PGM / RUN BY / DATE\n")
    if iono is not None and getattr(iono, "valid", False):
        a = "".join(f"{getattr(iono, f'alpha{k}'): 12.4E}" for k in range(4))
        b = "".join(f"{getattr(iono, f'beta{k}'): 12.4E}" for k in range(4))
        out.write(f"GPSA {a:<55}IONOSPHERIC CORR\n")
        out.write(f"GPSB {b:<55}IONOSPHERIC CORR\n")
    out.write(f"{leap_s:6d}{'':54}LEAP SECONDS\n")
    out.write(f"{'':60}END OF HEADER\n")
    return out.getvalue()


def _nav_rows(out, sysl, prn, t, clock3, rows):
    out.write(f"{sysl}{prn:02d} {t.year:4d} {t.month:02d} {t.day:02d} "
              f"{t.hour:02d} {t.minute:02d} {t.second:02d}"
              + "".join(_rnx(float(v)) for v in clock3) + "\n")
    for row in rows:
        out.write("    " + "".join(_rnx(float(v)) for v in row) + "\n")


_BDT_EPOCH = datetime.datetime(2006, 1, 1, tzinfo=datetime.timezone.utc)
_GLO_NT_EPOCH = datetime.datetime(1996, 1, 1, tzinfo=datetime.timezone.utc)


def rinex_nav_record(eph, version: int = 3) -> str:
    """One broadcast record, dispatched on the ephemeris type:
    GPS LNAV/CNAV (Keplerian), Galileo I/NAV, BeiDou D1, GLONASS state
    vector (rinex_printer.cc:1186 per-system nav writers).  version=2
    writes the 2.11 GPS format (I2 PRN + yy epoch, 3X-indented
    continuation rows) or the 2.11 GLONASS state-vector format (for the
    'G: GLONASS NAV DATA' file type); Galileo/BeiDou records in a 2.11
    file are a caller error (2.11 has no file type for them)."""
    out = io.StringIO()
    if version == 2:
        if hasattr(eph, "tb_s"):           # GLONASS 2.11 (I2 slot, yy epoch)
            day = _GLO_NT_EPOCH + datetime.timedelta(
                days=max(int(eph.nt_days) - 1, 0), seconds=eph.tb_s)
            t = day
            out.write(f"{eph.slot:2d} {t.year % 100:02d} {t.month:2d} "
                      f"{t.day:2d} {t.hour:2d} {t.minute:2d} "
                      f"{float(t.second):4.1f}"
                      + "".join(_rnx(float(v)) for v in
                                (-eph.tau_n_s, eph.gamma_n, eph.tk_s)) + "\n")
            for row in [(eph.x_km, eph.vx_kms, eph.ax_kms2, eph.health_bn),
                        (eph.y_km, eph.vy_kms, eph.ay_kms2,
                         eph.freq_channel),
                        (eph.z_km, eph.vz_kms, eph.az_kms2, 0.0)]:
                out.write("   " + "".join(_rnx(float(v)) for v in row) + "\n")
            return out.getvalue()
        if hasattr(eph, "iod_nav") \
                or getattr(eph, "system", "G") == "C" \
                or hasattr(eph, "sat_h1"):
            raise ValueError(
                "RINEX 2.11 nav files exist only for GPS (N:) and GLONASS "
                "(G:); write Galileo/BeiDou to 3.02")
        t = gps_time_to_utc(eph.week + 2048, eph.toc, leap_s=0)
        out.write(f"{eph.prn:2d} {t.year % 100:02d} {t.month:2d} {t.day:2d} "
                  f"{t.hour:2d} {t.minute:2d} {float(t.second):4.1f}"
                  + "".join(_rnx(float(v))
                            for v in (eph.af0, eph.af1, eph.af2)) + "\n")
        rows = [
            (eph.iode, eph.crs, eph.delta_n * np.pi, eph.m0 * np.pi),
            (eph.cuc, eph.e, eph.cus, eph.sqrt_a),
            (eph.toe, eph.cic, eph.omega0 * np.pi, eph.cis),
            (eph.i0 * np.pi, eph.crc, eph.omega * np.pi,
             eph.omega_dot * np.pi),
            (eph.idot * np.pi, 1.0, float(eph.week + 2048), 0.0),
            (2.0, float(eph.sv_health), eph.tgd, float(eph.iodc)),
            (0.0, 4.0, 0.0, 0.0),
        ]
        for row in rows:
            out.write("   " + "".join(_rnx(float(v)) for v in row) + "\n")
        return out.getvalue()
    if hasattr(eph, "tb_s"):               # GLONASS (4-line state vector)
        day = _GLO_NT_EPOCH + datetime.timedelta(
            days=max(int(eph.nt_days) - 1, 0), seconds=eph.tb_s)
        _nav_rows(out, "R", eph.slot, day,
                  (-eph.tau_n_s, eph.gamma_n, eph.tk_s),
                  [(eph.x_km, eph.vx_kms, eph.ax_kms2, eph.health_bn),
                   (eph.y_km, eph.vy_kms, eph.ay_kms2, eph.freq_channel),
                   (eph.z_km, eph.vz_kms, eph.az_kms2, 0.0)])
        return out.getvalue()
    if hasattr(eph, "iod_nav"):            # Galileo I/NAV
        t = gps_time_to_utc(eph.wn + 1024, eph.toc, leap_s=0)
        _nav_rows(out, "E", eph.prn, t, (eph.af0, eph.af1, eph.af2), [
            (eph.iod_nav, eph.crs, eph.delta_n * np.pi, eph.m0 * np.pi),
            (eph.cuc, eph.e, eph.cus, eph.sqrt_a),
            (eph.toe, eph.cic, eph.omega0 * np.pi, eph.cis),
            (eph.i0 * np.pi, eph.crc, eph.omega * np.pi,
             eph.omega_dot * np.pi),
            (eph.idot * np.pi, 513.0, float(eph.wn + 1024), 0.0),
            (3.12, 0.0, 0.0, 0.0),          # SISA, health, BGD E5a, E5b
            (0.0, 0.0, 0.0, 0.0),
        ])
        return out.getvalue()
    if getattr(eph, "system", "G") == "C" or hasattr(eph, "sat_h1"):
        # BeiDou D1 (BDT timescale: week 0 at 2006-01-01)
        t = _BDT_EPOCH + datetime.timedelta(weeks=eph.week, seconds=eph.toc)
        _nav_rows(out, "C", eph.prn, t, (eph.af0, eph.af1, eph.af2), [
            (eph.iode, eph.crs, eph.delta_n * np.pi, eph.m0 * np.pi),
            (eph.cuc, eph.e, eph.cus, eph.sqrt_a),
            (eph.toe, eph.cic, eph.omega0 * np.pi, eph.cis),
            (eph.i0 * np.pi, eph.crc, eph.omega * np.pi,
             eph.omega_dot * np.pi),
            (eph.idot * np.pi, 0.0, float(eph.week), 0.0),
            (2.0, float(eph.sat_h1), eph.tgd, getattr(eph, "tgd2", 0.0)),
            (0.0, float(eph.iodc), 0.0, 0.0),
        ])
        return out.getvalue()
    # GPS LNAV / CNAV-converted Keplerian
    t = gps_time_to_utc(eph.week + 2048, eph.toc, leap_s=0)
    _nav_rows(out, "G", eph.prn, t, (eph.af0, eph.af1, eph.af2), [
        (eph.iode, eph.crs, eph.delta_n * np.pi, eph.m0 * np.pi),
        (eph.cuc, eph.e, eph.cus, eph.sqrt_a),
        (eph.toe, eph.cic, eph.omega0 * np.pi, eph.cis),
        (eph.i0 * np.pi, eph.crc, eph.omega * np.pi, eph.omega_dot * np.pi),
        (eph.idot * np.pi, 1.0, float(eph.week + 2048), 0.0),
        (2.0, float(eph.sv_health), eph.tgd, float(eph.iodc)),
        (0.0, 4.0, 0.0, 0.0),
    ])
    return out.getvalue()


# ----------------------------------------------------------------- NMEA ----

def _nmea_checksum(body: str) -> str:
    c = 0
    for ch in body:
        c ^= ord(ch)
    return f"{c:02X}"


def _nmea_latlon(deg: float, is_lat: bool) -> tuple[str, str]:
    hemi = ("N" if deg >= 0 else "S") if is_lat else ("E" if deg >= 0 else "W")
    d = abs(deg)
    whole = int(d)
    minutes = (d - whole) * 60.0
    fmt = f"{whole:02d}" if is_lat else f"{whole:03d}"
    return f"{fmt}{minutes:09.6f}", hemi


def nmea_gga(sol: PvtSolution, utc: datetime.datetime) -> str:
    """$GPGGA sentence (nmea_printer.cc analogue)."""
    lat, ns = _nmea_latlon(sol.lat_deg, True)
    lon, ew = _nmea_latlon(sol.lon_deg, False)
    hdop = sol.dops["hdop"] if sol.dops else 0.0
    body = (f"GPGGA,{utc:%H%M%S}.00,{lat},{ns},{lon},{ew},1,"
            f"{sol.n_sats:02d},{hdop:.1f},{sol.height_m:.1f},M,0.0,M,,")
    return f"${body}*{_nmea_checksum(body)}"


def nmea_rmc(sol: PvtSolution, utc: datetime.datetime) -> str:
    lat, ns = _nmea_latlon(sol.lat_deg, True)
    lon, ew = _nmea_latlon(sol.lon_deg, False)
    speed_kt = float(np.linalg.norm(sol.rx_vel_ecef_ms)) * 1.9438445
    body = (f"GPRMC,{utc:%H%M%S}.00,A,{lat},{ns},{lon},{ew},"
            f"{speed_kt:.2f},0.0,{utc:%d%m%y},,,A")
    return f"${body}*{_nmea_checksum(body)}"


def nmea_gsa(sol: PvtSolution, used_prns: Iterable[int]) -> str:
    """$GPGSA — DOP and active satellites (nmea_printer.cc:205 get_GPGSA):
    auto 3D mode, up to 12 used PRNs, PDOP/HDOP/VDOP."""
    prns = [f"{p:02d}" for p in list(used_prns)[:12]]
    slots = ",".join(prns + [""] * (12 - len(prns)))
    d = sol.dops or {}
    body = (f"GPGSA,A,3,{slots},{d.get('pdop', 0.0):.1f},"
            f"{d.get('hdop', 0.0):.1f},{d.get('vdop', 0.0):.1f}")
    return f"${body}*{_nmea_checksum(body)}"


def nmea_gsv(sats: list[tuple[int, float, float, float]]) -> list[str]:
    """$GPGSV — satellites in view (nmea_printer.cc:219 get_GPGSV): each
    entry is (prn, elevation_deg, azimuth_deg, cn0_dbhz); 4 satellites per
    sentence, multi-sentence sequence numbering."""
    n = len(sats)
    n_msg = max((n + 3) // 4, 1)
    out = []
    for m in range(n_msg):
        chunk = sats[4 * m:4 * m + 4]
        body = f"GPGSV,{n_msg},{m + 1},{n:02d}"
        for prn, el, az, cn0 in chunk:
            body += (f",{prn:02d},{int(round(el)):02d},"
                     f"{int(round(az)) % 360:03d},{int(round(cn0)):02d}")
        out.append(f"${body}*{_nmea_checksum(body)}")
    return out


# ------------------------------------------------------- KML / GPX / GeoJSON

def kml_document(solutions: Iterable[PvtSolution], name: str = "gnss-sdr-1-tpu") -> str:
    coords = " ".join(
        f"{s.lon_deg:.9f},{s.lat_deg:.9f},{s.height_m:.3f}"
        for s in solutions if s.valid
    )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<kml xmlns="http://www.opengis.net/kml/2.2">\n'
        f"<Document><name>{name}</name><Placemark><LineString>\n"
        f"<coordinates>{coords}</coordinates>\n"
        "</LineString></Placemark></Document></kml>\n"
    )


def gpx_document(solutions: Iterable[PvtSolution], name: str = "gnss-sdr-1-tpu") -> str:
    pts = "\n".join(
        f'      <trkpt lat="{s.lat_deg:.9f}" lon="{s.lon_deg:.9f}">'
        f"<ele>{s.height_m:.3f}</ele></trkpt>"
        for s in solutions if s.valid
    )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        f'<gpx version="1.1" creator="{name}" '
        'xmlns="http://www.topografix.com/GPX/1/1">\n'
        f"  <trk><name>{name}</name><trkseg>\n{pts}\n"
        "  </trkseg></trk>\n</gpx>\n"
    )


def geojson_document(solutions: Iterable[PvtSolution]) -> str:
    import json

    coords = [
        [s.lon_deg, s.lat_deg, s.height_m] for s in solutions if s.valid
    ]
    return json.dumps({
        "type": "Feature",
        "geometry": {"type": "LineString", "coordinates": coords},
        "properties": {"name": "gnss-sdr-1-tpu position"},
    }, indent=1)
