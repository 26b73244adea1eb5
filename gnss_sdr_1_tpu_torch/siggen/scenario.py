"""Geometry-consistent multi-satellite scenarios.

Produces SatParams (delay/Doppler/Doppler-rate + LNAV bit streams) that are
CONSISTENT with a set of broadcast ephemerides and a receiver position, so
the full receiver chain (acquisition -> tracking -> telemetry -> observables
-> PVT) can be validated against known truth — the role the external
`gnss-sim` signal generator plays for the reference's system tests
(SURVEY.md §4, position_test.cc).

Timebase convention: receiver sample 0 corresponds to GPS time `t0_tow` on a
perfect receiver clock; each satellite's bit stream index k corresponds to
transmit time `bits_tow0 + k/50`, and the signal delay is the light time
minus the SV clock offset, fitted quadratically over the run.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import SPEED_OF_LIGHT_M_S, GPS_OMEGA_EARTH_DOT
from ..pvt.ephemeris import satellite_clock_correction, satellite_position_velocity
from ..telemetry.lnav import GpsEphemeris, encode_lnav_frame
from .generator import SatParams


def make_test_ephemeris(prn: int, toe: float, week: int = 220,
                        plane_raan_deg: float = 0.0, anomaly_deg: float = 0.0,
                        af0: float = 0.0) -> GpsEphemeris:
    """A plausible GPS MEO ephemeris (circular-ish, i=55 deg)."""
    def semicircles(deg: float) -> float:
        """Wrap an angle [deg] into the ICD's [-1, 1) semicircle range."""
        return ((deg / 180.0 + 1.0) % 2.0) - 1.0

    return GpsEphemeris(
        prn=prn, week=week,
        toc=toe, toe=toe,
        af0=af0, af1=0.0, af2=0.0, tgd=0.0,
        iodc=prn, iode=prn,
        sqrt_a=np.sqrt(26_560_000.0),
        e=0.004 + 0.0004 * (prn % 5),
        m0=semicircles(anomaly_deg),
        delta_n=4.2e-9 / np.pi,
        omega0=semicircles(plane_raan_deg),
        i0=np.radians(55.0) / np.pi,
        omega=np.radians(30.0 + prn) / np.pi,
        omega_dot=-8.0e-9 / np.pi,
        idot=2.0e-10 / np.pi,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
    )


def observed_delay_s(eph: GpsEphemeris, rx_ecef: np.ndarray, t_rx: float) -> float:
    """Light-time solution: delay from SV to receiver at GPS receive time
    t_rx, including earth rotation during flight and the SV clock offset
    (signal timeline runs on the SV clock)."""
    tau = 0.07
    for _ in range(4):
        t_tx = t_rx - tau
        pos, _ = satellite_position_velocity(eph, t_tx)
        theta = GPS_OMEGA_EARTH_DOT * tau
        c, s = np.cos(theta), np.sin(theta)
        pos_rot = np.array([
            c * pos[0] + s * pos[1], -s * pos[0] + c * pos[1], pos[2]
        ])
        tau = np.linalg.norm(pos_rot - rx_ecef) / SPEED_OF_LIGHT_M_S
    clk = satellite_clock_correction(eph, t_rx - tau)
    return tau - clk


def _auto_place(rx_ecef: np.ndarray, prns: list[int], toe: float,
                t0_tow: float) -> tuple[list[float], list[float]]:
    """Pick (raan, anomaly) per satellite so the constellation is spread in
    azimuth at 25-70 deg elevation above rx_ecef."""
    from ..pvt.geodesy import az_el

    n = len(prns)
    targets_az = [i * 360.0 / n for i in range(n)]
    raan_grid = np.arange(-180.0, 180.0, 20.0)
    anom_grid = np.arange(0.0, 360.0, 12.0)
    raans, anoms = [], []
    for i, prn in enumerate(prns):
        cands = []
        for raan in raan_grid:
            for anom in anom_grid:
                eph = make_test_ephemeris(prn, toe, plane_raan_deg=raan,
                                          anomaly_deg=anom)
                pos, _ = satellite_position_velocity(eph, t0_tow)
                az, el = az_el(rx_ecef, pos)
                el_deg = np.degrees(el)
                if 25.0 <= el_deg <= 70.0:
                    cands.append((np.degrees(az), el_deg, raan, anom))
        tgt_el = 35.0 + 20.0 * ((i % 3) - 1)
        best = min(
            cands,
            key=lambda c: min(abs(c[0] - targets_az[i]),
                              360 - abs(c[0] - targets_az[i])) + abs(c[1] - tgt_el),
        )
        raans.append(best[2])
        anoms.append(best[3])
    return raans, anoms


@dataclasses.dataclass
class Scenario:
    sats: list[SatParams]
    ephemerides: dict[int, GpsEphemeris]
    rx_ecef: np.ndarray
    t0_tow: float              # GPS TOW at receiver sample 0
    bits_tow0: float           # TOW at bit-stream index 0 (subframe boundary)
    truth: dict[int, dict]    # per-PRN delay/doppler truth at t=0
    # constant receiver velocity (dynamic scenarios; position_test.cc's
    # Spirent motion analogue) — truth position at t is rx_ecef + t*vel
    rx_vel_ecef: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))

    def rx_at(self, t_since_t0: float) -> np.ndarray:
        return self.rx_ecef + t_since_t0 * self.rx_vel_ecef


def _gps_to_galileo(eph):
    """Map the scenario's Keplerian truth onto the I/NAV broadcast fields."""
    from ..telemetry.inav import GalileoEphemeris

    return GalileoEphemeris(
        prn=eph.prn, iod_nav=eph.iode,
        toe=eph.toe, toc=eph.toc,
        m0=eph.m0, e=eph.e, sqrt_a=eph.sqrt_a,
        omega0=eph.omega0, i0=eph.i0, omega=eph.omega,
        omega_dot=eph.omega_dot, idot=eph.idot, delta_n=eph.delta_n,
        cuc=eph.cuc, cus=eph.cus, crc=eph.crc, crs=eph.crs,
        cic=eph.cic, cis=eph.cis,
        af0=eph.af0, af1=eph.af1, af2=eph.af2,
        wn=eph.week,
    )


def _gps_to_cnav(eph):
    """Map the scenario's Keplerian truth onto CNAV broadcast fields
    (delta terms vs the A_REF/OMEGA_DOT_REF constants of IS-GPS-200
    30.3.3.1.1 — the inverse of CnavEphemeris.to_keplerian)."""
    from ..telemetry.cnav import A_REF_M, OMEGA_DOT_REF_SC, CnavEphemeris

    return CnavEphemeris(
        prn=eph.prn, wn=eph.week, top=eph.toe, toe=eph.toe, toc=eph.toc,
        delta_a=eph.sqrt_a**2 - A_REF_M, a_dot=0.0,
        delta_n0=eph.delta_n, delta_n0_dot=0.0,
        m0=eph.m0, e=eph.e, omega=eph.omega, omega0=eph.omega0,
        i0=eph.i0, delta_omega_dot=eph.omega_dot - OMEGA_DOT_REF_SC,
        i0_dot=eph.idot,
        cis=eph.cis, cic=eph.cic, crs=eph.crs, crc=eph.crc,
        cus=eph.cus, cuc=eph.cuc,
        af0=eph.af0, af1=eph.af1, af2=eph.af2, tgd=eph.tgd,
    )


def _gps_to_beidou(eph):
    """Map the scenario's Keplerian truth onto D1 broadcast fields
    (system='C' selects the CGCS2000 constants in the propagator)."""
    from ..telemetry.beidou_dnav import BeidouEphemeris

    return BeidouEphemeris(
        prn=eph.prn, week=eph.week, toc=eph.toc, toe=eph.toe,
        af0=eph.af0, af1=eph.af1, af2=eph.af2, tgd=eph.tgd,
        iodc=eph.iodc, iode=eph.iode,
        sqrt_a=eph.sqrt_a, e=eph.e, m0=eph.m0, delta_n=eph.delta_n,
        omega0=eph.omega0, i0=eph.i0, omega=eph.omega,
        omega_dot=eph.omega_dot, idot=eph.idot,
        cuc=eph.cuc, cus=eph.cus, crc=eph.crc, crs=eph.crs,
        cic=eph.cic, cis=eph.cis)


def build_scenario(
    rx_ecef: np.ndarray,
    prns: list[int],
    t0_tow: float,
    duration_s: float,
    cn0_dbhz: float = 44.0,
    chip_rate: float | None = None,
    carrier_freq: float | None = None,
    raans: list[float] | None = None,
    anomalies: list[float] | None = None,
    subframe_cycle: tuple[int, ...] = (1, 2, 3, 4, 5),
    signal: str = "1C",
    fdma_ks: dict[int, int] | None = None,
    rx_vel_ecef: np.ndarray | None = None,
) -> Scenario:
    """Build consistent SatParams + ephemerides for `prns` visible from
    rx_ecef.  Orbit planes/anomalies default to a spread that puts the
    satellites above the horizon for a receiver near the prime meridian
    mid-latitudes; pass explicit raans/anomalies otherwise.  GPS L1 C/A
    (LNAV), GPS L2CM and L5I (CNAV), Galileo E1B (I/NAV), Galileo E5a-I
    (F/NAV), GLONASS L1 C/A (GNAV, each slot on its FDMA carrier
    `fdma_ks[slot]`) and BeiDou B1I (D1 NAV on CGCS2000 ephemerides; B3I
    callers pass its chip rate and carrier) only."""
    if signal not in ("1C", "2S", "L5", "1B", "5X", "1G", "B1"):
        raise NotImplementedError(
            f"signal {signal!r} is not ported (GPS '1C', '2S', 'L5', "
            f"Galileo '1B', '5X', GLONASS '1G' and BeiDou 'B1' only)")
    from ..constants import SIGNALS

    if chip_rate is None:
        # the delay<->chips conversion must use the rate the generator
        # indexes the code table with (callers tracking at a virtual rate,
        # e.g. E1 sinBOC 2.046e6, pass it explicitly)
        chip_rate = float(SIGNALS[signal].code_rate_chips_s)
    if carrier_freq is None:
        carrier_freq = float(SIGNALS[signal].carrier_freq_hz)
    toe = np.floor(t0_tow / 7200.0) * 7200.0   # ephemeris reference nearby
    # bit stream starts at the last subframe (LNAV and D1, 6 s), CNAV
    # message (L5 6 s, L2CM 12 s), GNAV frame (30 s) or page (I/NAV and
    # F/NAV streams, 2 s) boundary before the earliest possible transmit
    # time (t0 - 0.1 s)
    boundary = {"1C": 6.0, "B1": 6.0, "1G": 30.0,
                "L5": 6.0, "2S": 12.0}.get(signal, 2.0)
    bits_tow0 = np.floor((t0_tow - 0.1) / boundary) * boundary

    sats: list[SatParams] = []
    ephs: dict[int, GpsEphemeris] = {}
    truth: dict[int, dict] = {}
    _vel = (np.zeros(3) if rx_vel_ecef is None
            else np.asarray(rx_vel_ecef, float))

    def _rx_at(t_rx: float) -> np.ndarray:
        """Receiver ECEF at GPS receive time (constant-velocity motion)."""
        return rx_ecef + (t_rx - t0_tow) * _vel
    if raans is None or anomalies is None:
        raans, anomalies = _auto_place(rx_ecef, prns, toe, t0_tow)
    for i, prn in enumerate(prns):
        raan = raans[i]
        anom = anomalies[i]
        eph = make_test_ephemeris(prn, toe, plane_raan_deg=raan,
                                  anomaly_deg=anom, af0=2e-5 * ((i % 3) - 1))
        if signal == "B1":
            # the receiver propagates B1 ephemerides with CGCS2000
            # constants; keep truth and broadcast on the same model
            eph = _gps_to_beidou(eph)
        carrier_offset = 0.0
        if signal == "1G":
            # GLONASS: broadcast is a state vector at tb (multiple of 900 s)
            # propagated by RK4; the truth delays use the SAME quantized
            # broadcast + RK4 model the receiver will, so geometry is exact
            # (glonass_gnav_ephemeris.cc simplified_satellite_position)
            from ..pvt.glonass_orbits import (
                glonass_clock_correction, glonass_satpos)
            from ..telemetry.gnav import (
                GlonassEphemeris, decode_string, encode_string)

            k_fdma = (fdma_ks or {}).get(prn, 0)
            carrier_offset = 0.5625e6 * k_fdma
            tb = np.round((t0_tow + duration_s / 2.0) / 900.0) * 900.0
            pos_tb, vel_tb = satellite_position_velocity(eph, tb)
            g0 = GlonassEphemeris(
                slot=prn, freq_channel=k_fdma, tb_s=tb % 86400.0,
                x_km=pos_tb[0] / 1e3, y_km=pos_tb[1] / 1e3,
                z_km=pos_tb[2] / 1e3,
                vx_kms=vel_tb[0] / 1e3, vy_kms=vel_tb[1] / 1e3,
                vz_kms=vel_tb[2] / 1e3,
                tau_n_s=-eph.af0, nt_days=100 + prn)
            geph = GlonassEphemeris(slot=prn)
            for sid in (1, 2, 3, 4):       # broadcast-quantized round trip
                decode_string(encode_string(sid, g0), geph)
            geph.tk_s = 0.0                # tk comes per-frame below
            ephs[prn] = geph

            def observed(t_rx, _g=geph):
                tau = 0.07
                for _ in range(4):
                    p, _v = glonass_satpos(_g, t_rx - tau)
                    th = GPS_OMEGA_EARTH_DOT * tau
                    c, s = np.cos(th), np.sin(th)
                    pr = np.array([c * p[0] + s * p[1],
                                   -s * p[0] + c * p[1], p[2]])
                    tau = np.linalg.norm(
                        pr - _rx_at(t_rx)) / SPEED_OF_LIGHT_M_S
                return tau - glonass_clock_correction(_g, t_rx - tau)
        else:
            ephs[prn] = eph

            def observed(t_rx, _e=eph):
                return observed_delay_s(_e, _rx_at(t_rx), t_rx)
        # cubic fit of observed delay over the run (the quadratic residual
        # of a MEO pass over 24 s is meters; cubic leaves centimeters)
        ts = np.linspace(0.0, duration_s, 5)
        taus = np.array([observed(t0_tow + dt) for dt in ts])
        coef = np.polyfit(ts, taus, 3)     # tau(t) ~ c3 t^3 + ... + c0
        tau0, tau_dot = coef[3], coef[2]
        fc_i = carrier_freq + carrier_offset   # FDMA: the slot's own carrier
        doppler = -fc_i * tau_dot
        doppler_rate = -fc_i * 2.0 * coef[1]
        doppler_rate2 = -carrier_freq * 6.0 * coef[0]
        # delay of the bit/code stream relative to the bits_tow0 origin:
        # stream time at rx t is (t0_tow + t - tau(t)) - bits_tow0, so the
        # generator's delay (stream starts at chips=0) is tau0 minus the
        # stream time already elapsed at t=0.
        stream_offset_s = t0_tow - bits_tow0
        delay_chips = (tau0 - stream_offset_s) * chip_rate
        # nav bits covering the run (+ margin)
        bit_rate_override = None
        if signal == "B1":
            # D1 NAV: 6 s subframes cycling 1,2,3 so the ephemeris
            # completes in 18 s (fixture analogue of the GPS
            # subframe_cycle); 50 bps bits, NH20 applied by the caller
            from ..telemetry.beidou_dnav import (
                d1_fields_for, encode_subframe_bits)

            n_sf = int(np.ceil((duration_s + 2.0) / 6.0)) + 2
            cyc = (1, 2, 3)
            sfs = []
            for k in range(n_sf):
                fid = cyc[k % 3]
                sfs.append(encode_subframe_bits(
                    fid, bits_tow0 + 6.0 * k, d1_fields_for(eph, fid)))
            bits01 = np.concatenate(sfs)
        elif signal == "1B":
            # I/NAV pages (2 s each), word cycle 5,1,2,3,4 so ephemeris +
            # GST complete within 10 s; GST TOW = even-part start time
            from ..telemetry.inav import encode_page, encode_word

            geph = _gps_to_galileo(eph)
            n_pages = int(np.ceil((duration_s + 2.0) / 2.0)) + 2
            cycle = (5, 1, 2, 3, 4)
            pages = []
            for k in range(n_pages):
                geph.tow = bits_tow0 + 2.0 * k
                pages.append(encode_page(encode_word(cycle[k % 5], geph)))
            bits01 = np.concatenate(pages)
        elif signal in ("L5", "2S"):
            # CNAV message stream (types 10, 11, 30 cycling; 6 s per message
            # on L5 at 100 sps, 12 s on L2CM at 50 sps), K=7 r=1/2 FEC.
            # L5I additionally carries NH10 per 1 ms code period — expand
            # symbols x10 against NH10 into an effective 1 kbps stream.
            from ..telemetry.cnav import encode_message
            from ..utils.native import conv27_encode

            ceph = _gps_to_cnav(eph)
            msg_s = 6.0 if signal == "L5" else 12.0
            n_msgs = int(np.ceil((duration_s + 2.0) / msg_s)) + 2
            cyc = (10, 11, 30)
            msgs = [encode_message(cyc[k % 3], ceph,
                                   bits_tow0 + (k + 1) * msg_s)
                    for k in range(n_msgs)]
            syms01 = conv27_encode(np.concatenate(msgs))
            if signal == "L5":
                from ..codes.gps_l5 import NH10

                d = np.repeat(1.0 - 2.0 * syms01, 10)
                nh = np.tile(np.asarray(NH10, dtype=np.float64),
                             len(syms01))
                bits01 = (1.0 - d * nh) / 2.0     # back to 0/1 for the
                bit_rate_override = 1000.0        # common conversion below
            else:
                bits01 = syms01
                bit_rate_override = 50.0
        elif signal == "5X":
            # E5a-I F/NAV: 10 s pages at 50 sps, page types 1-4 cycling so
            # the ephemeris (+GST) completes in 40 s
            # (galileo_e5a ICD 4.2; telemetry/fnav.py encode_page).  Each
            # 20 ms symbol spans 20 primary code periods modulated by the
            # CS20 secondary — expand to an effective 1 kbps stream like
            # the L5I NH10 branch above.
            from ..codes.galileo_e5 import galileo_e5ai_secondary
            from ..telemetry.fnav import encode_page

            geph5 = _gps_to_galileo(eph)
            n_pages = int(np.ceil((duration_s + 2.0) / 10.0)) + 2
            # page order override via subframe_cycle (e.g. (4,1,2,3) lets a
            # receiver starting mid-page-0 complete pages 1-4 by t+40 s)
            cyc5 = tuple(t for t in subframe_cycle
                         if 1 <= t <= 4) or (1, 2, 3, 4)
            pages = []
            for k in range(n_pages):
                geph5.tow = bits_tow0 + 10.0 * k
                pages.append(encode_page(cyc5[k % 4], geph5))
            syms01 = np.concatenate(pages)
            d = np.repeat(1.0 - 2.0 * syms01, 20)
            cs = np.tile(np.asarray(galileo_e5ai_secondary(),
                                    dtype=np.float64), len(syms01))
            bits01 = (1.0 - d * cs) / 2.0
            bit_rate_override = 1000.0
        elif signal == "1G":
            # GNAV 30 s frames of 15 strings (2 s each): strings 1-4 carry
            # the ephemeris, 5-15 are filler (almanac slots); string 1
            # starts each frame and its tk anchors time-of-day at the frame
            # boundary.  The stream is the 100-sps meander SYMBOL sequence
            # (bit_rate_override below), not 50 bps bits.
            from ..telemetry.gnav import encode_string, string_to_symbols

            g_tx = ephs[prn]
            n_frames = int(np.ceil((duration_s + 2.0) / 30.0)) + 1
            syms = []
            for f in range(n_frames):
                g_tx.tk_s = (bits_tow0 + 30.0 * f) % 86400.0
                for sid in list(range(1, 16)):
                    syms.append(string_to_symbols(
                        encode_string(min(sid, 15), g_tx)))
            bits01 = np.concatenate(syms)
            bit_rate_override = 100.0
        else:
            n_sf = int(np.ceil((duration_s + 2.0) / 6.0)) + 2
            bits01 = encode_lnav_frame(eph, bits_tow0, n_subframes=n_sf,
                                       subframe_cycle=subframe_cycle)
        nav_bits = (1.0 - 2.0 * bits01).astype(np.float64)
        sats.append(SatParams(
            prn=prn, doppler_hz=doppler, doppler_rate_hz_s=doppler_rate,
            doppler_rate2_hz_s2=doppler_rate2,
            delay_chips=delay_chips, cn0_dbhz=cn0_dbhz,
            phase_rad=float(2.0 * np.pi * ((i * 0.37) % 1.0)),
            nav_bits=nav_bits,
            carrier_offset_hz=carrier_offset,
            bit_rate_override_bps=bit_rate_override,
        ))
        truth[prn] = {
            "delay_s": tau0, "doppler_hz": doppler,
            "doppler_rate_hz_s": doppler_rate,
        }
    return Scenario(sats=sats, ephemerides=ephs, rx_ecef=rx_ecef,
                    t0_tow=t0_tow, bits_tow0=bits_tow0, truth=truth,
                    rx_vel_ecef=(np.zeros(3) if rx_vel_ecef is None
                                 else np.asarray(rx_vel_ecef, float)))
