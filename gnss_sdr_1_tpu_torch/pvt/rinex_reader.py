"""RINEX 3 multi-constellation navigation-file reader.

Reference parity: the rinex2assist utility (src/utils/rinex2assist/) —
converts broadcast RINEX nav into assistance data for warm/hot starts;
parses GPS/Galileo/BeiDou Keplerian records and GLONASS state vectors.
Round-trips with pvt.printers.rinex_nav_record.
"""

from __future__ import annotations

import datetime

import numpy as np

from ..telemetry.lnav import GpsEphemeris


def _f(tok: str) -> float:
    tok = tok.strip()
    if not tok:
        return 0.0
    return float(tok.replace("D", "E").replace("d", "e"))


def _fields(line: str, start: int, n: int) -> list[float]:
    return [_f(line[start + 19 * k : start + 19 * (k + 1)])
            for k in range(n) if len(line) > start + 19 * k]


_BDT_EPOCH = datetime.datetime(2006, 1, 1, tzinfo=datetime.timezone.utc)
_GLO_NT_EPOCH = datetime.datetime(1996, 1, 1, tzinfo=datetime.timezone.utc)


def _epoch_seconds(line: str) -> tuple[datetime.datetime, float]:
    y, mo, d, h, mi, s = (int(line[4:8]), int(line[9:11]), int(line[12:14]),
                          int(line[15:17]), int(line[18:20]),
                          int(line[21:23]))
    t = datetime.datetime(y, mo, d, h, mi, s,
                          tzinfo=datetime.timezone.utc)
    return t, h * 3600.0 + mi * 60.0 + s


def read_rinex_nav_mixed(path: str) -> dict[str, dict[int, object]]:
    """Parse every record of a RINEX 3.x mixed navigation file into
    {'G': {prn: GpsEphemeris}, 'E': {...}, 'C': {...}, 'R': {...}} with
    each system's native broadcast model."""
    from ..telemetry.beidou_dnav import BeidouEphemeris
    from ..telemetry.gnav import GlonassEphemeris
    from ..telemetry.inav import GalileoEphemeris

    lines = open(path, "r", errors="replace").read().splitlines()
    i = 0
    while i < len(lines) and "END OF HEADER" not in lines[i]:
        i += 1
    i += 1
    out: dict[str, dict[int, object]] = {"G": {}, "E": {}, "C": {}, "R": {}}
    while i < len(lines):
        line = lines[i]
        sysl = line[:1]
        if sysl not in out or len(line) < 23:
            i += 1
            continue
        prn = int(line[1:3])
        clock3 = _fields(line, 23, 3)
        if sysl == "R":
            rows = [_fields(lines[i + r], 4, 4) for r in range(1, 4)]
            t, _tod = _epoch_seconds(line)
            nt = (t - _GLO_NT_EPOCH).days + 1
            tb = (t - t.replace(hour=0, minute=0, second=0)).total_seconds()
            out["R"][prn] = GlonassEphemeris(
                slot=prn, tau_n_s=-clock3[0], gamma_n=clock3[1],
                tk_s=clock3[2], tb_s=tb, nt_days=nt,
                x_km=rows[0][0], vx_kms=rows[0][1], ax_kms2=rows[0][2],
                health_bn=int(rows[0][3]),
                y_km=rows[1][0], vy_kms=rows[1][1], ay_kms2=rows[1][2],
                freq_channel=int(rows[1][3]),
                z_km=rows[2][0], vz_kms=rows[2][1], az_kms2=rows[2][2],
            )
            i += 4
            continue
        rows = [_fields(lines[i + r], 4, 4) for r in range(1, 8)]
        kep = dict(
            crs=rows[0][1], delta_n=rows[0][2] / np.pi,
            m0=rows[0][3] / np.pi,
            cuc=rows[1][0], e=rows[1][1], cus=rows[1][2], sqrt_a=rows[1][3],
            toe=rows[2][0], cic=rows[2][1], omega0=rows[2][2] / np.pi,
            cis=rows[2][3],
            i0=rows[3][0] / np.pi, crc=rows[3][1], omega=rows[3][2] / np.pi,
            omega_dot=rows[3][3] / np.pi,
            idot=rows[4][0] / np.pi,
            af0=clock3[0], af1=clock3[1], af2=clock3[2],
        )
        if sysl == "G":
            out["G"][prn] = GpsEphemeris(
                prn=prn, iode=int(rows[0][0]),
                week=int(rows[4][2]) % 2048,
                sv_health=int(rows[5][1]), tgd=rows[5][2],
                iodc=int(rows[5][3]), toc=rows[2][0], **kep)
        elif sysl == "E":
            out["E"][prn] = GalileoEphemeris(
                prn=prn, iod_nav=int(rows[0][0]),
                wn=int(rows[4][2]) - 1024, toc=rows[2][0], **kep)
        elif sysl == "C":
            out["C"][prn] = BeidouEphemeris(
                prn=prn, iode=int(rows[0][0]), week=int(rows[4][2]),
                sat_h1=int(rows[5][1]), tgd=rows[5][2],
                iodc=int(rows[6][1]), toc=rows[2][0], **kep)
        i += 8
    return out


def read_rinex_nav(path: str) -> dict[int, GpsEphemeris]:
    """GPS records only (backwards-compatible entry point)."""
    return read_rinex_nav_mixed(path)["G"]
