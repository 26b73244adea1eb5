"""Command-line receiver: the reference's `gnss-sdr --config_file=...` entry.

Reference parity: src/main/main.cc (gflags CLI + ControlThread) — run a
configuration over a file capture, print PVT fixes, write
RINEX/NMEA/KML/GPX/GeoJSON/RTCM outputs.  The data plane (conditioner,
acquisition, tracking) runs on the card unless `--device cpu` asks for the
CPU; without a card the CLI exits with an error.

Usage:
    python -m gnss_sdr_1_tpu_torch --config_file conf/my.conf [--signal_file x.dat]
    python -m gnss_sdr_1_tpu_torch --signal_file cap.dat --item_type ishort \\
        --fs 4e6 [--out_dir out/] [--device cpu]

This port runs GPS L1 C/A, L2C and L5, Galileo E1B and E5a, GLONASS
L1/L2 C/A and BeiDou B1I/B3I channel groups (PCPS and its variants, CAF on
E5a, DLL/PLL, VEML or, on GPS L1, KF tracking, single-point PVT); a conf
with several groups runs them together with one joint PVT
(runtime.multi_receiver).  `--assist` (a runtime.assistance JSON) and
`--supl` (a SUPL server, runtime.supl) narrow acquisition to the predicted
Doppler windows; `--base_obs` (an RTCM file of base MT1005 + MSM epochs)
runs the DGNSS/RTK baseline processor per PVT.positioning_mode, and the
PPP_* modes run PPP after the capture (PVT.sp3_file: precise products).
`--telecommand_port` serves the TcpCmdInterface commands while the
receiver runs (runtime.telecommand); `--monitor_port` and
`--pvt_monitor_port` stream Gnss_Synchro records and PVT fixes over UDP
(runtime.monitor).
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gnss_sdr_1_tpu_torch")
    ap.add_argument("-c", "--config_file", help="reference-style .conf file")
    ap.add_argument("--signal_file", help="IQ capture path (overrides conf)")
    ap.add_argument("--item_type", default=None,
                    help="ishort|ibyte|byte|short|gr_complex")
    ap.add_argument("--fs", type=float, default=None, help="sampling rate")
    ap.add_argument("--signal", default=None,
                    help="signal id (1C, 2S, L5, 1B, 5X, 1G, 2G, B1, B3)")
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--max_s", type=float, default=None,
                    help="process at most this many seconds")
    ap.add_argument("--out_dir", default=".", help="output directory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    ap.add_argument("--doppler_max", type=float, default=None)
    ap.add_argument("--telecommand_port", type=int, default=None,
                    help="start the TcpCmdInterface on this port")
    ap.add_argument("--monitor_port", type=int, default=None,
                    help="stream Gnss_Synchro records to this UDP port")
    ap.add_argument("--pvt_monitor_port", type=int, default=None,
                    help="stream PVT solutions to this UDP port")
    ap.add_argument("--base_obs", default=None,
                    help="RTCM file with base-station MT1005 + MSM epochs: "
                         "engages the DGNSS/RTK baseline processor per "
                         "PVT.positioning_mode (rtklib relpos analogue)")
    ap.add_argument("--assist", default=None,
                    help="A-GNSS assistance JSON (runtime.assistance store)")
    ap.add_argument("--supl", default=None, metavar="HOST[:PORT]",
                    help="fetch A-GNSS assistance from a SUPL server "
                         "(GNSS-SDR.SUPL_gps_enabled analogue; default "
                         "port 7275)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(message)s")

    from . import resolve_device
    from .io import FileSignalSource
    from .io.formats import FORMATS
    from .pvt import printers
    from .runtime import Receiver, ReceiverConfig
    from .runtime.config import (PORTED_SIGNALS, FileConfiguration,
                                 build_frontend, conf_signal_groups,
                                 not_ported, to_receiver_config,
                                 to_receiver_configs)

    if args.signal and args.signal not in PORTED_SIGNALS:
        ap.error(str(not_ported(f"signal '{args.signal}'")))
    try:
        dev = resolve_device(args.device)
    except RuntimeError:
        ap.error("no CUDA device available; --device cpu runs on the CPU")

    frontend = None
    rinex_version = 3
    multi_cfgs = None
    conf = None
    if args.config_file:
        conf = FileConfiguration(args.config_file)
        # signals and blocks neither package carries raise;
        # multi-constellation confs (Channels_1C.count + Channels_1B.count
        # style) run concurrent channel groups with one joint ISB PVT
        # (gnss_flowgraph.cc:1722 set_signals_list)
        try:
            rcfg = to_receiver_config(conf)
            if len(conf_signal_groups(conf)) > 1:
                multi_cfgs = to_receiver_configs(conf)
        except NotImplementedError as e:
            ap.error(f"{args.config_file}: {e}")
        # PVT.rinex_version (rinex_printer.cc:106 d_version): 2 -> 2.11
        rinex_version = 2 if str(conf.property(
            "PVT.rinex_version", "3")).strip().startswith("2") else 3
        frontend = build_frontend(conf)
        signal_file = args.signal_file or conf.property(
            "SignalSource.filename", "")
        item_type = args.item_type or conf.property(
            "SignalSource.item_type", "ishort")
    else:
        if not args.signal_file:
            ap.error("need --config_file or --signal_file")
        rcfg = ReceiverConfig()
        signal_file = args.signal_file
        item_type = args.item_type or "ishort"
    if args.signal:
        rcfg = type(rcfg)(**{**rcfg.__dict__, "signal_id": args.signal})
    if args.fs:
        rcfg = type(rcfg)(**{**rcfg.__dict__, "fs_hz": args.fs})
    if args.channels:
        rcfg = type(rcfg)(**{**rcfg.__dict__, "n_channels": args.channels})
    if args.doppler_max:
        rcfg = type(rcfg)(**{**rcfg.__dict__, "doppler_max_hz": args.doppler_max})

    if item_type not in FORMATS:
        ap.error(f"unknown item_type {item_type!r}; choose from "
                 f"{sorted(FORMATS)}")
    if not pathlib.Path(signal_file).exists():
        ap.error(f"signal file not found: {signal_file}")
    # the SignalConditioner chain runs at the SOURCE rate
    # (signal_conditioner.cc; wiring gnss_block_factory.cc:234-252)
    source_fs = frontend.source_fs_hz if frontend else rcfg.fs_hz
    max_samples = int(args.max_s * source_fs) if args.max_s else None
    src = FileSignalSource(signal_file, item_type=item_type,
                           sampling_frequency=source_fs,
                           max_samples=max_samples)
    print(f"Processing {src.n_samples} samples "
          f"({src.n_samples / source_fs:.1f} s) of {signal_file} "
          f"[{item_type}] with {rcfg.n_channels} {rcfg.signal_id} channels")
    samples = src.read(0, src.n_samples)
    if frontend is not None and not frontend.is_passthrough:
        print(f"Conditioning: fs {frontend.source_fs_hz:.0f} -> "
              f"{frontend.internal_fs_hz:.0f} Hz, IF {frontend.if_freq_hz:.0f}"
              f" Hz, filter {frontend.filter_impl}, "
              f"resampler {frontend.resampler_impl}")
        samples = frontend.process(samples, device=dev)

    if args.monitor_port:
        rcfg = type(rcfg)(**{**rcfg.__dict__, "enable_monitor": True,
                             "monitor_port": args.monitor_port})
    if args.pvt_monitor_port:
        rcfg = type(rcfg)(**{**rcfg.__dict__, "enable_pvt_monitor": True,
                             "pvt_monitor_port": args.pvt_monitor_port})

    if multi_cfgs is not None:
        return _run_multi(multi_cfgs, samples, src.n_samples / source_fs,
                          pathlib.Path(args.out_dir), dev)

    rx = Receiver(rcfg, device=dev)
    rx.preload(samples)
    _assist(rx, args)
    tcmd = None
    if args.telecommand_port:
        from .runtime.telecommand import TelecommandServer

        tcmd = TelecommandServer(rx, port=args.telecommand_port)
        print(f"Telecommand listening on port {tcmd.start()}")
    t0 = time.time()
    try:
        sols = rx.process(samples)
    finally:
        if tcmd is not None:
            tcmd.stop()
    dt = time.time() - t0
    dur = len(samples) / rcfg.fs_hz
    print(f"Processed in {dt:.1f} s (RTF {dur / dt:.2f}x); "
          f"{len(sols)} PVT fixes")
    if args.base_obs and rx.obs_epochs:
        _baseline(rx, rcfg, args.base_obs)
    if rcfg.positioning_mode.upper().startswith("PPP") and rx.obs_epochs:
        # PVT.sp3_file: precise orbits/clocks (rtklib EPHOPT_PREC via
        # pvt.precise.read_sp3); absent -> broadcast PPP
        sp3_file = conf.property("PVT.sp3_file", "") if conf else ""
        _ppp(rx, sp3_file or None)

    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if not sols:
        print("No position fix obtained.")
        return 0
    last = sols[-1]
    print(f"Final fix: lat {last.lat_deg:.6f} lon {last.lon_deg:.6f} "
          f"h {last.height_m:.1f} m  sats {last.n_sats} "
          f"pdop {last.dops['pdop']:.2f}")
    (out / "position.kml").write_text(printers.kml_document(sols))
    (out / "position.gpx").write_text(printers.gpx_document(sols))
    (out / "position.geojson").write_text(printers.geojson_document(sols))
    ephs = {p: d.ephemeris for p, d in rx.decoders.items()
            if d.ephemeris_complete}
    nmea = []
    # GPGSV satellite roster from the final fix's geometry
    gsv_sats = []
    if last.valid and ephs:
        from .pvt.geodesy import az_el
        from .pvt.solver import sat_pos_vel
        for p, e in sorted(ephs.items()):
            try:
                pos, _ = sat_pos_vel(e, last.rx_time_tow_s)
                az, el = az_el(last.rx_ecef_m, pos)
                cn0 = next((o.cn0_dbhz for _, obs in rx.obs_epochs[-1:]
                            for q, o in obs.items() if q == p), 0.0)
                gsv_sats.append((p, np.degrees(el), np.degrees(az), cn0))
            except Exception:
                continue
    for s in sols:
        utc = printers.gps_time_to_utc(2240, s.rx_time_tow_s)
        nmea.append(printers.nmea_gga(s, utc))
        nmea.append(printers.nmea_rmc(s, utc))
    if last.valid:
        nmea.append(printers.nmea_gsa(
            last, sorted(p for _, obs in rx.obs_epochs[-1:] for p in obs)))
        nmea.extend(printers.nmea_gsv(gsv_sats))
    (out / "position.nmea").write_text("\n".join(nmea) + "\n")
    # RINEX 2.11 has file types for GPS and GLONASS only: Galileo keeps
    # 3.02
    file_ver = rinex_version if rcfg.signal_id in (
        "1C", "2S", "L5", "1G", "2G") else 3
    glonass = rcfg.signal_id in ("1G", "2G")
    # epochs in GPS time: a GLONASS group's receiver time is the GLONASS
    # time of day, dated by its ephemerides' day number (the JAX CLI raises
    # AttributeError here on a GLONASS group)
    week, tow_shift = (_glonass_gps_week(ephs) if glonass else (next(
        (d.ephemeris.week for d in rx.decoders.values()
         if d.ephemeris_complete), 0) + 2048, 0.0))
    if rx.obs_epochs:
        tows = [tow + tow_shift for tow, _ in rx.obs_epochs]
        interval = (round(np.median(np.diff(tows)), 3)
                    if len(tows) > 1 else None)
        obs_txt = [printers.rinex_obs_header(
            approx_xyz=last.rx_ecef_m,
            signals=(rcfg.signal_id,),
            glonass_slots=dict(rcfg.fdma_k) or None,
            version=file_ver,
            time_first_obs=printers.gps_time_to_utc(week, tows[0], leap_s=0),
            interval_s=interval)]
        for tow, (_, obs) in zip(tows, rx.obs_epochs):
            obs_txt.append(printers.rinex_obs_epoch(week, tow, {
                p: {"pseudorange_m": o.pseudorange_m,
                    "carrier_phase_cycles": o.carrier_phase_cycles,
                    "doppler_hz": o.doppler_hz,
                    "cn0_dbhz": o.cn0_dbhz}
                for p, o in obs.items()}, signal=rcfg.signal_id,
                version=file_ver, signals=(rcfg.signal_id,)))
        (out / "observables.rnx").write_text("".join(obs_txt))
    # nav records and RTCM ephemerides in each system's own broadcast
    # model: the Galileo adapter hands the solver a Keplerian conversion,
    # RINEX and RTCM take the I/NAV record
    if rcfg.signal_id == "1B":
        ephs = {p: d.raw.ephemeris for p, d in rx.decoders.items()
                if d.ephemeris_complete}
    if ephs:
        iono = next((d.iono for d in rx.decoders.values()
                     if getattr(getattr(d, "iono", None), "valid", False)),
                    None)
        nav = printers.rinex_nav_header(
            iono=iono, version=file_ver,
            system="R" if glonass else "G") + "".join(
            printers.rinex_nav_record(e, version=file_ver)
            for e in ephs.values())
        (out / "brdc.rnx").write_text(nav)
    # RTCM 3.2 stream: station + ephemerides + MSM7 epochs
    # (rtcm_printer.cc Print_Rtcm_MSM / Print_Rtcm_MT1019)
    from .pvt import rtcm as rtcm_mod
    system = rtcm_mod.SYSTEM_OF_SIGNAL.get(rcfg.signal_id, "GPS")
    lam = 299792458.0 / rcfg.spec.carrier_freq_hz
    frames = [rtcm_mod.encode_mt1005(1234, last.rx_ecef_m,
                                     gps=system == "GPS",
                                     glonass=system == "GLONASS",
                                     galileo=system == "Galileo")]
    frames += [f for f in (rtcm_mod.encode_ephemeris(e)
                           for e in ephs.values()) if f]
    t_first = rx.obs_epochs[0][0] if rx.obs_epochs else 0.0
    # RTCM phase range is +range-like; the receiver's integrated-NCO phase
    # is -range/lambda plus an arbitrary per-channel start offset.  Anchor
    # each satellite's phase range to its first pseudorange at an INTEGER
    # cycle count (real receivers do the same at lock), so MSM fine-phase
    # fits and DD ambiguities stay integers for RTK consumers of the stream.
    phase_anchor: dict[int, float] = {}
    for tow, obs in rx.obs_epochs:
        for p, o in obs.items():
            if p not in phase_anchor:
                phase_anchor[p] = lam * round(
                    (o.pseudorange_m + o.carrier_phase_cycles * lam) / lam)
        msm_obs = [rtcm_mod.MsmObs(
            sat=p, signal=rcfg.signal_id,
            pseudorange_m=o.pseudorange_m,
            phase_range_m=phase_anchor[p] - o.carrier_phase_cycles * lam,
            phase_rate_ms=-o.doppler_hz * lam,
            lock_time_s=tow - t_first, cn0_dbhz=o.cn0_dbhz,
            wavelength_m=lam)
            for p, o in obs.items()]
        if msm_obs:
            tow_ms = int((tow + tow_shift) * 1e3) % 604800000
            epoch = (rtcm_mod.glonass_msm_epoch(tow_ms)
                     if system == "GLONASS" else tow_ms)
            frames.append(rtcm_mod.encode_msm(system, 7, 1234, epoch,
                                              msm_obs))
    (out / "observables.rtcm").write_bytes(b"".join(frames))
    print(f"Outputs written to {out}/")
    return 0


def _assist(rx, args) -> None:
    """--assist and --supl: A-GNSS predictions from a saved assistance
    file or a SUPL session narrow the receiver's acquisition grid
    (Receiver.set_assistance), printing the JAX CLI's lines."""
    from .pvt.geodesy import llh_to_ecef

    if args.assist:
        from .runtime.assistance import load_assistance

        a_ephs, a_llh, a_tow = load_assistance(args.assist)
        if a_ephs and a_llh is not None and a_tow is not None:
            n_vis = rx.set_assistance(
                a_ephs, llh_to_ecef(np.radians(a_llh[0]),
                                    np.radians(a_llh[1]), a_llh[2]), a_tow)
            print(f"A-GNSS: {n_vis} satellites predicted visible")
    if args.supl:
        from .runtime.supl import SUPL_PORT, SuplClient

        host, _, port = args.supl.partition(":")
        cli = SuplClient(host, int(port) if port else SUPL_PORT)
        if cli.get_assistance() == 0:
            print(f"SUPL: {len(cli.gps_ephemeris_map)} ephemerides, "
                  f"{len(cli.gps_acq_map)} acq-assist entries received")
            if (cli.gps_ephemeris_map and cli.gps_ref_loc is not None
                    and cli.gps_time is not None):
                lat, lon, alt = cli.gps_ref_loc
                n_vis = rx.set_assistance(
                    cli.gps_ephemeris_map,
                    llh_to_ecef(np.radians(lat), np.radians(lon), alt),
                    cli.gps_time[1])
                print(f"SUPL A-GNSS: {n_vis} satellites predicted visible")
        else:
            print("SUPL: assistance request failed")


def _baseline(rx, rcfg, base_obs: str) -> None:
    """--base_obs: the DGNSS/RTK baseline processor on the rover's
    observables against the base's RTCM epochs (the EKF in Kinematic
    mode, and for Single; the batch solver otherwise)."""
    from .pvt.rtcm import read_base_observables
    from .pvt.rtk import solve_baseline
    from .pvt.rtk_ekf import solve_baseline_ekf

    mode = rcfg.positioning_mode
    if mode.upper() in ("SINGLE",):
        mode = "Kinematic"
    lam = 299792458.0 / rcfg.spec.carrier_freq_hz
    with open(base_obs, "rb") as f:
        base_ecef, base_epochs = read_base_observables(
            f.read(), signal=rcfg.signal_id)
    ephs_rtk = {p: d.ephemeris for p, d in rx.decoders.items()
                if d.ephemeris_complete}
    if base_ecef is None or not base_epochs:
        print("base_obs: no MT1005/MSM data decoded")
    elif mode.upper().startswith("KIN"):
        ek = solve_baseline_ekf(rx.obs_epochs, base_epochs, base_ecef,
                                ephs_rtk, lam, mode="Kinematic")
        n_fix = sum(s.fixed for s in ek)
        if ek:
            last = ek[-1]
            pos = (last.rover_fixed_ecef_m if last.fixed
                   else last.rover_float_ecef_m)
            print(f"RTK EKF: {len(ek)} epochs, {n_fix} fixed "
                  f"(last ratio {last.ratio:.1f}); rover ECEF "
                  f"[{pos[0]:.3f} {pos[1]:.3f} {pos[2]:.3f}]")
        else:
            print("RTK EKF: no matched base/rover epochs")
    else:
        sol = solve_baseline(rx.obs_epochs, base_epochs, base_ecef,
                             ephs_rtk, lam, mode=mode)
        if sol.valid:
            tag = "fixed" if sol.fixed else "float"
            print(f"RTK {mode}: {tag} baseline, ratio {sol.ratio:.1f}, "
                  f"rover ECEF [{sol.rover_ecef_m[0]:.3f} "
                  f"{sol.rover_ecef_m[1]:.3f} "
                  f"{sol.rover_ecef_m[2]:.3f}]")
        else:
            print(f"RTK {mode}: no baseline solution")


def _ppp(rx, sp3_file) -> None:
    """PVT.positioning_mode=PPP_*: PPP over the run's observables
    (Receiver.solve_ppp_batch), printing the JAX CLI's line."""
    ppp = rx.solve_ppp_batch(sp3=sp3_file)
    if ppp.valid:
        from .pvt.geodesy import ecef_to_llh

        lat, lon, hgt = ecef_to_llh(ppp.rx_ecef_m)
        print(f"PPP ({ppp.mode}): lat {np.degrees(lat):.7f} "
              f"lon {np.degrees(lon):.7f} h {hgt:.2f} m  "
              f"ztd_wet {ppp.ztd_wet_m:.3f} m  epochs {ppp.n_epochs} "
              f"arcs {ppp.n_arcs} sigma0 {ppp.sigma0_m:.2f} m")
    else:
        print("PPP: no solution (insufficient epochs/satellites)")


def _glonass_gps_week(ephs) -> tuple[int, float]:
    """GPS week, and GPS seconds into it, of 00:00 GLONASS time on the day
    that the GLONASS ephemerides' NT names, counted from 1996 as the nav
    records date their state vectors.  GLONASS time is UTC(SU) + 3 h, GPS
    time UTC + 18 s."""
    import datetime

    from .pvt import printers

    nt = next(int(e.nt_days) for e in ephs.values())
    day = printers._GLO_NT_EPOCH + datetime.timedelta(
        days=max(nt - 1, 0), hours=-3, seconds=18)
    week, sow = divmod((day - printers._GPS_EPOCH).total_seconds(), 604800.0)
    return int(week), sow


def _run_multi(cfgs, samples, dur: float, out: pathlib.Path, dev) -> int:
    """Several channel groups over one stream with one joint PVT, printing
    the JAX CLI's lines and writing its KML/GPX/GeoJSON/NMEA outputs."""
    from .pvt import printers
    from .runtime.multi_receiver import MultiReceiver

    names = "+".join(c.signal_id for c in cfgs)
    print(f"Mixed-constellation run: {names} "
          f"({'/'.join(str(c.n_channels) for c in cfgs)} channels)")
    mrx = MultiReceiver(cfgs, device=dev)
    t0 = time.time()
    joint = mrx.process(samples)
    dt = time.time() - t0
    print(f"Processed in {dt:.1f} s (RTF {dur / dt:.2f}x); "
          f"{len(joint)} joint PVT fixes")
    out.mkdir(parents=True, exist_ok=True)
    if not joint:
        print("No joint position fix obtained.")
        return 0
    sols = [j.solution for j in joint]
    last = sols[-1]
    used = ", ".join(f"{sysl}:{len(p)}" for sysl, p in
                     sorted(joint[-1].per_system_prns.items()))
    print(f"Final joint fix: lat {last.lat_deg:.6f} lon {last.lon_deg:.6f} "
          f"h {last.height_m:.1f} m ({used})")
    (out / "position.kml").write_text(printers.kml_document(sols))
    (out / "position.gpx").write_text(printers.gpx_document(sols))
    (out / "position.geojson").write_text(printers.geojson_document(sols))
    nmea = []
    for s in sols:
        utc = printers.gps_time_to_utc(2240, s.rx_time_tow_s)
        nmea.append(printers.nmea_gga(s, utc))
        nmea.append(printers.nmea_rmc(s, utc))
    (out / "position.nmea").write_text("\n".join(nmea) + "\n")
    print(f"Outputs written to {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
