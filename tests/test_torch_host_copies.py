"""The PyTorch port's own copies of the numpy host modules give the same
results as the JAX package's, and the port imports nothing of JAX or of the
JAX package."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import gnss_sdr_1_tpu.codes as jcodes
import gnss_sdr_1_tpu.pvt.solver as jsolver
import gnss_sdr_1_tpu.siggen.scenario as jscen
import gnss_sdr_1_tpu.telemetry.decoder as jdecoder
import gnss_sdr_1_tpu.telemetry.lnav as jlnav
import gnss_sdr_1_tpu_torch.codes as tcodes
import gnss_sdr_1_tpu_torch.pvt.solver as tsolver
import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
import gnss_sdr_1_tpu_torch.telemetry.decoder as tdecoder
import gnss_sdr_1_tpu_torch.telemetry.lnav as tlnav
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef

ROOT = pathlib.Path(__file__).resolve().parent.parent
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
PRNS = [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("prn", range(1, 33))
def test_gps_l1ca_codes_bit_identical(prn):
    a = jcodes.gps_l1ca_code(prn)
    b = tcodes.gps_l1ca_code(prn)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    ra = jcodes.tracking_replica("1C", prn)
    rb = tcodes.tracking_replica("1C", prn)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:]


def test_resample_code_identical():
    chips = jcodes.gps_l1ca_code(7)
    for fs in (2.046e6, 4.092e6, 4e6):
        n = int(round(fs * 1e-3))
        np.testing.assert_array_equal(
            jcodes.resample_code(chips, fs, 1.023e6, n),
            tcodes.resample_code(chips, fs, 1.023e6, n))


def _scenarios():
    kw = dict(t0_tow=345601.25, duration_s=24.0, cn0_dbhz=47.0,
              subframe_cycle=(1, 2, 3))
    return (jscen.build_scenario(RX, PRNS, **kw),
            tscen.build_scenario(RX, PRNS, **kw))


def test_scenario_ephemerides_and_signals_identical():
    sj, st = _scenarios()
    assert sj.t0_tow == st.t0_tow and sj.bits_tow0 == st.bits_tow0
    for p in PRNS:
        assert dataclasses.asdict(sj.ephemerides[p]) == \
            dataclasses.asdict(st.ephemerides[p])
    for a, b in zip(sj.sats, st.sats):
        assert (a.prn, a.doppler_hz, a.delay_chips, a.doppler_rate_hz_s) \
            == (b.prn, b.doppler_hz, b.delay_chips, b.doppler_rate_hz_s)
        np.testing.assert_array_equal(a.nav_bits, b.nav_bits)


def test_generator_identical():
    from gnss_sdr_1_tpu.constants import GPS_L1_CA as JL1
    from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA as TL1
    from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband as tgen

    sj, st = _scenarios()
    codes = {p: jcodes.gps_l1ca_code(p) for p in PRNS}
    a = jgen(JL1, sj.sats, codes, 2.046e6, 0.01, noise=True)
    b = tgen(TL1, st.sats, codes, 2.046e6, 0.01, noise=True)
    np.testing.assert_array_equal(a, b)


def test_lnav_encode_decode_round_trip():
    """A scenario frame encodes to the same bits in both packages and both
    decoders recover the same ephemeris and TOW from it."""
    sj, _ = _scenarios()
    eph = sj.ephemerides[3]
    bits_j = jlnav.encode_lnav_frame(eph, 345600.0, n_subframes=5)
    bits_t = tlnav.encode_lnav_frame(
        tlnav.GpsEphemeris(**dataclasses.asdict(eph)), 345600.0,
        n_subframes=5)
    np.testing.assert_array_equal(bits_j, bits_t)
    ej, et = jlnav.GpsEphemeris(prn=3), tlnav.GpsEphemeris(prn=3)
    d29 = d30 = 0
    for k in range(3):
        sf = bits_t[k * 300:(k + 1) * 300]
        rj = jlnav.decode_subframe(sf, d29, d30, ej)
        rt = tlnav.decode_subframe(sf, d29, d30, et)
        assert rj == rt and rt is not None
        d29, d30 = int(sf[-2]), int(sf[-1])
    assert dataclasses.asdict(ej) == dataclasses.asdict(et)
    for name in ("sqrt_a", "e", "m0", "omega0", "i0", "omega", "toe"):
        assert getattr(et, name) == pytest.approx(getattr(eph, name),
                                                  rel=1e-6, abs=1e-9)


def test_lnav_decoder_symbol_stream_identical():
    """Both decoders fed the same 20-epoch symbol stream agree on bit sync,
    TOW and ephemeris."""
    sj, _ = _scenarios()
    bits = 1.0 - 2.0 * jlnav.encode_lnav_frame(
        sj.ephemerides[2], 345600.0, n_subframes=4, subframe_cycle=(1, 2, 3))
    rng = np.random.default_rng(5)
    prompts = np.repeat(bits, 20) * 100.0 + rng.normal(size=20 * len(bits))
    prompts = prompts[7:]
    starts = np.arange(len(prompts), dtype=np.int64) * 2046
    dj, dt = jdecoder.LnavDecoder(2), tdecoder.LnavDecoder(2)
    for k in range(0, len(prompts), 997):
        dj.push(prompts[k:k + 997], starts[k:k + 997])
        dt.push(prompts[k:k + 997], starts[k:k + 997])
    assert dj.bit_offset == dt.bit_offset is not None
    assert dj.ephemeris_complete and dt.ephemeris_complete
    for s in (0, 5000, len(prompts) - 1):
        assert dj.tow_at_symbol(s) == dt.tow_at_symbol(s)
    assert dataclasses.asdict(dj.ephemeris) == \
        dataclasses.asdict(dt.ephemeris)


def test_solve_pvt_identical():
    sj, st = _scenarios()
    t = sj.t0_tow + 1.0
    prs = {}
    rng = np.random.default_rng(1)
    for p in PRNS:
        tau = jscen.observed_delay_s(sj.ephemerides[p], RX, t)
        prs[p] = tau * 299792458.0 + 1500.0 + rng.normal() * 2.0
    dops = {p: sj.truth[p]["doppler_hz"] for p in PRNS}
    a = jsolver.solve_pvt(sj.ephemerides, prs, t, dopplers_hz=dops,
                          el_mask_deg=5.0, weighted=True)
    b = tsolver.solve_pvt(st.ephemerides, prs, t, dopplers_hz=dops,
                          el_mask_deg=5.0, weighted=True)
    assert a.valid and b.valid and a.n_sats == b.n_sats
    np.testing.assert_array_equal(a.rx_ecef_m, b.rx_ecef_m)
    np.testing.assert_array_equal(a.rx_vel_ecef_ms, b.rx_vel_ecef_ms)
    assert a.rx_clock_bias_s == b.rx_clock_bias_s
    assert np.linalg.norm(b.rx_ecef_m - RX) < 20.0


# ---------------------------------------------------------------------------
# io/, pvt/printers.py, pvt/rtcm.py, telemetry/gnav.py, telemetry/inav.py
# ---------------------------------------------------------------------------

import gnss_sdr_1_tpu.io as jio  # noqa: E402
import gnss_sdr_1_tpu.pvt.printers as jprint  # noqa: E402
import gnss_sdr_1_tpu.pvt.rtcm as jrtcm  # noqa: E402
import gnss_sdr_1_tpu.telemetry.gnav as jgnav  # noqa: E402
import gnss_sdr_1_tpu.telemetry.inav as jinav  # noqa: E402
import gnss_sdr_1_tpu_torch.io as tio  # noqa: E402
import gnss_sdr_1_tpu_torch.pvt.printers as tprint  # noqa: E402
import gnss_sdr_1_tpu_torch.pvt.rtcm as trtcm  # noqa: E402
import gnss_sdr_1_tpu_torch.telemetry.gnav as tgnav  # noqa: E402
import gnss_sdr_1_tpu_torch.telemetry.inav as tinav  # noqa: E402
import gnss_sdr_1_tpu_torch.utils.native as tnative  # noqa: E402


def _raw_items(fmt, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(fmt.dtype)
    if dt.kind == "c":
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=n, endpoint=True,
                        dtype=np.int64).astype(dt)


@pytest.mark.parametrize("name", sorted(jio.FORMATS))
def test_io_format_conversion_identical(name, tmp_path):
    assert sorted(tio.FORMATS) == sorted(jio.FORMATS)
    fj, ft = jio.FORMATS[name], tio.FORMATS[name]
    assert dataclasses.asdict(fj) == dataclasses.asdict(ft)
    raw = _raw_items(fj, 4001 * fj.items_per_sample, 21)
    want = jio.convert_to_complex64(raw, fj)
    got = tio.convert_to_complex64(raw, ft)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    # the file source: whole reads, offset reads inside sub-byte items, and
    # the valve bound
    path = tmp_path / f"cap.{name}"
    raw.tofile(path)
    kw = dict(item_type=name, sampling_frequency=4e6, max_samples=3000,
              skip_samples=3)
    sj = jio.FileSignalSource(str(path), **kw)
    st = tio.FileSignalSource(str(path), **kw)
    assert st.n_samples == sj.n_samples
    for start, count in ((0, st.n_samples), (5, 1001), (2990, 50)):
        np.testing.assert_array_equal(st.read(start, count),
                                      sj.read(start, count))
    np.testing.assert_array_equal(tio.read_capture(str(path), name),
                                  jio.read_capture(str(path), name))


def _solutions(mod):
    from importlib import import_module

    solver = import_module(mod + ".pvt.solver")
    out = []
    for k in range(3):
        out.append(solver.PvtSolution(
            True, np.array([4797671.0 + k, 166532.5, 4185477.25 - k]),
            1.5e-4, np.array([0.01, -0.02, 0.003]), 2e-9,
            345600.0 + 0.1 * k, lat_deg=41.275 + 1e-6 * k,
            lon_deg=1.988 - 2e-6 * k, height_m=80.0 + k,
            dops={"pdop": 2.0, "hdop": 1.0, "vdop": 1.5, "gdop": 2.4,
                  "tdop": 1.1}, n_sats=8 - k))
    return out


def _iono(lnav_mod):
    return lnav_mod.GpsIono(alpha0=1.1e-8, alpha1=1.5e-8, alpha2=-6e-8,
                            alpha3=-1.2e-7, beta0=9.2e4, beta1=1.3e5,
                            beta2=-6.5e4, beta3=-5.2e5, valid=True)


def test_printers_identical():
    from gnss_sdr_1_tpu.siggen.scenario import make_test_ephemeris as jeph
    from gnss_sdr_1_tpu_torch.siggen.scenario import \
        make_test_ephemeris as teph

    sj, st = _solutions("gnss_sdr_1_tpu"), _solutions("gnss_sdr_1_tpu_torch")
    utc_j = jprint.gps_time_to_utc(2240, 345600.0)
    utc_t = tprint.gps_time_to_utc(2240, 345600.0)
    assert utc_t == utc_j
    for fn in ("kml_document", "gpx_document", "geojson_document"):
        assert getattr(tprint, fn)(st) == getattr(jprint, fn)(sj), fn
    for fn in ("nmea_gga", "nmea_rmc"):
        for a, b in zip(sj, st):
            assert getattr(tprint, fn)(b, utc_t) == getattr(jprint, fn)(
                a, utc_j)
    assert tprint.nmea_gsa(st[-1], [3, 5, 9, 22]) == \
        jprint.nmea_gsa(sj[-1], [3, 5, 9, 22])
    sats = [(p, 10.0 + 7 * p, 3.5 * p, 40.0 + p) for p in range(1, 11)]
    assert tprint.nmea_gsv(sats) == jprint.nmea_gsv(sats)
    obs = {5: {"pseudorange_m": 21000000.123,
               "carrier_phase_cycles": -110363000.456, "doppler_hz": 1234.5,
               "cn0_dbhz": 44.0},
           17: {"pseudorange_m": 23456789.012,
                "carrier_phase_cycles": -123456789.987,
                "doppler_hz": -4321.0, "cn0_dbhz": 31.5}}
    for ver in (2, 3):
        kw = dict(approx_xyz=sj[-1].rx_ecef_m, signals=("1C",),
                  glonass_slots=None, version=ver, interval_s=0.02)
        assert tprint.rinex_obs_header(
            time_first_obs=tprint.gps_time_to_utc(2240, 345600.0, leap_s=0),
            **kw) == jprint.rinex_obs_header(
            time_first_obs=jprint.gps_time_to_utc(2240, 345600.0, leap_s=0),
            **kw)
        assert tprint.rinex_obs_epoch(2240, 345600.02, obs, signal="1C",
                                      version=ver, signals=("1C",)) == \
            jprint.rinex_obs_epoch(2240, 345600.02, obs, signal="1C",
                                   version=ver, signals=("1C",))
        assert tprint.rinex_nav_header(iono=_iono(tlnav), version=ver) == \
            jprint.rinex_nav_header(iono=_iono(jlnav), version=ver)
        for prn in (3, 17):
            assert tprint.rinex_nav_record(teph(prn, 345600.0),
                                           version=ver) == \
                jprint.rinex_nav_record(jeph(prn, 345600.0), version=ver)


def _glonass(mod):
    return mod.GlonassEphemeris(
        slot=5, freq_channel=-4, tb_s=8100.0, tk_s=8130.0,
        x_km=11987.33, y_km=-18234.12, z_km=9123.001,
        vx_kms=1.25553, vy_kms=-0.33221, vz_kms=2.11113,
        ax_kms2=2.8e-9, ay_kms2=-9.3e-10, az_kms2=0.0,
        gamma_n=1.8e-11, tau_n_s=-6.7e-5, health_bn=0, nt_days=731)


def _galileo(mod):
    return mod.GalileoEphemeris(
        prn=11, wn=1130, iod_nav=87, toe=356400.0, toc=356400.0,
        sqrt_a=5440.6, e=2.3e-4, m0=-0.25, delta_n=8.1e-10, omega0=0.41,
        i0=0.311, omega=-0.6, omega_dot=-1.8e-9, idot=-6e-11,
        cuc=-5e-7, cus=8e-6, crc=131.1, crs=-9.8, cic=2e-8, cis=4e-8,
        af0=6.1e-4, af1=-8.2e-12, af2=0.0)


def test_rtcm_frames_identical():
    from gnss_sdr_1_tpu.siggen.scenario import make_test_ephemeris as jeph
    from gnss_sdr_1_tpu_torch.siggen.scenario import \
        make_test_ephemeris as teph

    ecef = (4797671.0, 166532.5, 4185477.25)
    for kw in (dict(gps=True), dict(glonass=True), dict(galileo=True),
               dict(gps=True, height_m=1.25)):
        assert trtcm.encode_mt1005(1234, ecef, **kw) == \
            jrtcm.encode_mt1005(1234, ecef, **kw)
    pairs = ((teph(7, 345600.0), jeph(7, 345600.0)),
             (_glonass(tgnav), _glonass(jgnav)),
             (_galileo(tinav), _galileo(jinav)))
    for et, ej in pairs:
        ft, fj = trtcm.encode_ephemeris(et), jrtcm.encode_ephemeris(ej)
        assert ft == fj and ft
    lam = 299792458.0 / 1575.42e6
    sig = {"GPS": "1C", "GLONASS": "1G", "Galileo": "1B"}
    for system in ("GPS", "GLONASS", "Galileo"):
        obs_t, obs_j = ([mod.MsmObs(
            sat=p, signal=sig[system],
            pseudorange_m=2.1e7 + 1e4 * p + 0.37,
            phase_range_m=2.1e7 + 1e4 * p + 0.41,
            phase_rate_ms=-612.3 * p * lam, lock_time_s=12.5 + p,
            cn0_dbhz=40.0 + 0.25 * p, wavelength_m=lam)
            for p in (3, 9, 14)] for mod in (trtcm, jrtcm))
        ep = jrtcm.glonass_msm_epoch(345600000) if system == "GLONASS" \
            else 345600000
        assert trtcm.glonass_msm_epoch(345600000) == \
            jrtcm.glonass_msm_epoch(345600000)
        ft = trtcm.encode_msm(system, 7, 1234, ep, obs_t)
        assert ft == jrtcm.encode_msm(system, 7, 1234, ep, obs_j)
        msgnum, payload = trtcm.deframe(ft)
        assert trtcm.decode_msm(payload) == jrtcm.decode_msm(payload)
    payload = bytes(range(40))
    assert tnative.crc24q(payload) == jrtcm.crc24q(payload)
    assert trtcm.frame(payload) == jrtcm.frame(payload)


@pytest.mark.parametrize("pair", [(tgnav, jgnav), (tinav, jinav)],
                         ids=["gnav", "inav"])
def test_gnav_inav_dataclasses_identical(pair):
    tmod, jmod = pair
    names = [n for n, v in vars(jmod).items()
             if dataclasses.is_dataclass(v) and v.__module__ == jmod.__name__]
    assert names
    for n in names:
        ft = [(f.name, f.default) for f in dataclasses.fields(getattr(tmod, n))]
        fj = [(f.name, f.default) for f in dataclasses.fields(getattr(jmod, n))]
        assert ft == fj, n
    if tmod is tgnav:
        et, ej = _glonass(tgnav), _glonass(jgnav)
        for sid in (1, 2, 3, 4):
            bt = tgnav.encode_string(sid, et)
            np.testing.assert_array_equal(bt, jgnav.encode_string(sid, ej))
            np.testing.assert_array_equal(tgnav.string_to_symbols(bt),
                                          jgnav.string_to_symbols(bt))
            dt, dj = tgnav.GlonassEphemeris(), jgnav.GlonassEphemeris()
            assert tgnav.decode_string(bt, dt) == jgnav.decode_string(bt, dj)
            assert dataclasses.asdict(dt) == dataclasses.asdict(dj)
    else:
        et, ej = _galileo(tinav), _galileo(jinav)
        for wt in (1, 2, 3, 4):
            wt_bits = tinav.encode_word(wt, et)
            np.testing.assert_array_equal(wt_bits, jinav.encode_word(wt, ej))
            page = tinav.encode_page(wt_bits)
            np.testing.assert_array_equal(page, jinav.encode_page(wt_bits))
            dt, dj = tinav.GalileoEphemeris(), jinav.GalileoEphemeris()
            assert tinav.decode_word(wt_bits, dt) == jinav.decode_word(
                wt_bits, dj)
            assert dataclasses.asdict(dt) == dataclasses.asdict(dj)
        kt, kj = tinav.to_keplerian(et), jinav.to_keplerian(ej)
        assert dataclasses.asdict(kt) == dataclasses.asdict(kj)


# ---------------------------------------------------------------------------
# Galileo E1: constants, the 1B scenario and generator, the channel decoder
# ---------------------------------------------------------------------------

import gnss_sdr_1_tpu.constants as jconst  # noqa: E402
import gnss_sdr_1_tpu.telemetry.channel_adapters as jadapt  # noqa: E402
import gnss_sdr_1_tpu_torch.constants as tconst  # noqa: E402
import gnss_sdr_1_tpu_torch.telemetry.channel_adapters as tadapt  # noqa: E402


def test_galileo_constants_identical():
    for name in ("GALILEO_GM", "GALILEO_OMEGA_EARTH_DOT", "FREQ_E1"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    assert dataclasses.asdict(tconst.SIGNALS["1B"]) == \
        dataclasses.asdict(jconst.SIGNALS["1B"])
    assert tconst.SIGNALS["1B"].chips_per_symbol == \
        jconst.SIGNALS["1B"].chips_per_symbol


def _e1_scenarios(prns=(2, 4, 7)):
    kw = dict(t0_tow=345601.25, duration_s=12.0, cn0_dbhz=48.0,
              chip_rate=2.046e6, signal="1B")
    return (jscen.build_scenario(RX, list(prns), **kw),
            tscen.build_scenario(RX, list(prns), **kw))


def test_e1_scenario_and_generator_identical():
    from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
    from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband as tgen

    sj, st = _e1_scenarios()
    assert sj.bits_tow0 == st.bits_tow0
    for a, b in zip(sj.sats, st.sats):
        assert (a.prn, a.doppler_hz, a.delay_chips, a.doppler_rate_hz_s) \
            == (b.prn, b.doppler_hz, b.delay_chips, b.doppler_rate_hz_s)
        np.testing.assert_array_equal(a.nav_bits, b.nav_bits)
    spec_j = dataclasses.replace(jconst.GALILEO_E1B, code_rate_chips_s=2.046e6,
                                 code_length_chips=8184, bit_rate_bps=250.0)
    spec_t = dataclasses.replace(tconst.GALILEO_E1B, code_rate_chips_s=2.046e6,
                                 code_length_chips=8184, bit_rate_bps=250.0)
    codes = {s.prn: jcodes.tracking_replica("1B", s.prn)[0] for s in sj.sats}
    np.testing.assert_array_equal(
        tgen(spec_t, st.sats, codes, 4.0e6, 0.01, noise=True),
        jgen(spec_j, sj.sats, codes, 4.0e6, 0.01, noise=True))


def test_galileo_channel_decoder_identical():
    """Both E1B channel decoders fed the same soft I/NAV symbols (a
    scenario's pages, word cycle 5,1,2,3,4, with noise, starting in the odd
    part of a page) agree on page sync, GST TOW, the I/NAV record and its
    Keplerian conversion.  (Where the JAX decoder fails, the port's
    differs: tests/test_torch_galileo.py test_inav_decoder_resyncs.)"""
    sj, _ = _e1_scenarios((4,))
    bits = np.asarray(sj.sats[0].nav_bits)
    rng = np.random.default_rng(2)
    prompts = (bits * 80.0 + rng.normal(size=len(bits)) * 10.0)[287:]
    dj, dt = jadapt.GalileoChannelDecoder(4), tadapt.GalileoChannelDecoder(4)
    for k in range(0, len(prompts), 250):
        dj.push(prompts[k:k + 250])
        dt.push(prompts[k:k + 250])
    assert dj.ephemeris_complete and dt.ephemeris_complete
    assert dt.raw.page_sync == dj.raw.page_sync
    for s in (0, 1000, len(prompts) - 1):
        assert dt.tow_at_symbol(s) == dj.tow_at_symbol(s)
    assert dataclasses.asdict(dt.raw.ephemeris) == \
        dataclasses.asdict(dj.raw.ephemeris)
    assert dataclasses.asdict(dt.ephemeris) == \
        dataclasses.asdict(dj.ephemeris)
    assert dt.ephemeris.sqrt_a == pytest.approx(sj.ephemerides[4].sqrt_a,
                                                abs=2e-5)


# ---------------------------------------------------------------------------
# GPS L5 and Galileo E5a: CNAV, F/NAV, the channel adapters, the scenario
# ---------------------------------------------------------------------------

import inspect  # noqa: E402

import gnss_sdr_1_tpu.telemetry.cnav as jcnav  # noqa: E402
import gnss_sdr_1_tpu.telemetry.fnav as jfnav  # noqa: E402
import gnss_sdr_1_tpu_torch.telemetry.cnav as tcnav  # noqa: E402
import gnss_sdr_1_tpu_torch.telemetry.fnav as tfnav  # noqa: E402


@pytest.mark.parametrize("pair", [(tcnav, jcnav), (tfnav, jfnav)],
                         ids=["cnav", "fnav"])
def test_cnav_fnav_identical(pair):
    """The dataclasses, the encoders and the decoders of both message
    formats agree, from the scenario's broadcast conversions (the F/NAV
    copy uses the port's I/NAV helpers, which the port's decoder repair
    left as they were)."""
    tmod, jmod = pair
    names = [n for n, v in vars(jmod).items()
             if dataclasses.is_dataclass(v) and v.__module__ == jmod.__name__]
    assert names
    for n in names:
        ft = [(f.name, f.default) for f in dataclasses.fields(getattr(tmod, n))]
        fj = [(f.name, f.default) for f in dataclasses.fields(getattr(jmod, n))]
        assert ft == fj, n
    for n in ("_get", "_put", "_q", "_fec_encode"):
        assert inspect.getsource(getattr(tinav, n)) == inspect.getsource(
            getattr(jinav, n)), n
    sj, _ = _scenarios()
    eph = sj.ephemerides[5]
    if tmod is tcnav:
        ej, et = jscen._gps_to_cnav(eph), tscen._gps_to_cnav(eph)
        assert dataclasses.asdict(et) == dataclasses.asdict(ej)
        iono = _iono(jlnav)
        for mt in (10, 11, 30):
            bt = tcnav.encode_message(mt, et, 345606.0, iono=_iono(tlnav))
            np.testing.assert_array_equal(
                bt, jcnav.encode_message(mt, ej, 345606.0, iono=iono))
            assert tcnav.crc_check(bt) and jcnav.crc_check(bt)
        kt, kj = et.to_keplerian(), ej.to_keplerian()
        assert dataclasses.asdict(kt) == dataclasses.asdict(kj)
        assert kt.sqrt_a == pytest.approx(eph.sqrt_a, abs=1e-3)
    else:
        gj, gt = jscen._gps_to_galileo(eph), tscen._gps_to_galileo(eph)
        gj.tow = gt.tow = 345610.0
        for ptype in (1, 2, 3, 4):
            st = tfnav.encode_page(ptype, gt)
            np.testing.assert_array_equal(st, jfnav.encode_page(ptype, gj))
            soft = np.where(st[12:] > 0, 255, 0).astype(np.uint8)
            bt = tfnav.decode_symbols(soft)
            np.testing.assert_array_equal(bt, jfnav.decode_symbols(soft))
            dt, dj = tinav.GalileoEphemeris(), jinav.GalileoEphemeris()
            assert tfnav.decode_page_bits(bt, dt) == jfnav.decode_page_bits(
                bt, dj) == ptype
            assert dataclasses.asdict(dt) == dataclasses.asdict(dj)


@pytest.mark.parametrize("name", ["GpsL5ChannelDecoder",
                                  "GalileoE5aChannelDecoder"])
def test_l5_e5a_adapters_are_copies(name):
    """The port's L5 and E5a channel adapters are the JAX package's, line
    for line (tests/test_torch_l5_e5a.py feeds both the same prompts)."""
    assert inspect.getsource(getattr(tadapt, name)) == inspect.getsource(
        getattr(jadapt, name))


def _port_sources():
    files = sorted((ROOT / "gnss_sdr_1_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_port.py"]
    return files


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's profiler
    import neither jax nor anything of the JAX package."""
    files = _port_sources()
    assert len(files) > 20
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "gnss_sdr_1_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"{name}")
    assert not bad, bad
    # the data files the port reads are its own copies
    from gnss_sdr_1_tpu_torch.codes import data as tdata

    assert tdata._NPZ.is_file()
    assert (ROOT / "gnss_sdr_1_tpu_torch") in tdata._NPZ.resolve().parents


# ---------------------------------------------------------------------------
# GPS L2C and GLONASS: constants, codes, orbits, the adapters, the scenario
# ---------------------------------------------------------------------------


def test_l2c_glonass_constants_identical():
    for name in ("FREQ_L2", "FREQ_G1_GLO", "DFRQ1_GLO", "FREQ_G2_GLO",
                 "DFRQ2_GLO"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for sid in ("2S", "1G", "2G"):
        assert dataclasses.asdict(tconst.SIGNALS[sid]) == \
            dataclasses.asdict(jconst.SIGNALS[sid])
    assert sorted(tconst.SIGNALS) == sorted(jconst.SIGNALS)
    for sid in ("1G", "2G", "1C"):
        for k in range(-7, 7):
            assert tconst.glonass_fdma_offset_hz(sid, k) == \
                jconst.glonass_fdma_offset_hz(sid, k)


@pytest.mark.parametrize("rel", ["codes/glonass.py", "codes/gps_l2c.py",
                                 "pvt/glonass_orbits.py"])
def test_l2c_glonass_modules_are_copies(rel):
    """The L2CM and GLONASS code generators and the GLONASS RK4 orbit are
    the JAX package's modules, byte for byte."""
    assert (ROOT / "gnss_sdr_1_tpu_torch" / rel).read_text() == \
        (ROOT / "gnss_sdr_1_tpu" / rel).read_text()


def test_l2_glonass_adapters_are_copies():
    """GpsL2ChannelDecoder line for line; GlonassChannelDecoder but for
    the import of its GNAV decoder (the port's own copy)."""
    assert inspect.getsource(tadapt.GpsL2ChannelDecoder) == \
        inspect.getsource(jadapt.GpsL2ChannelDecoder)
    src_t = inspect.getsource(tadapt.GlonassChannelDecoder)
    src_j = inspect.getsource(jadapt.GlonassChannelDecoder)
    assert src_t.replace(
        "from .gnav import GnavDecoder\n\n        self._dec = "
        "GnavDecoder(slot)",
        "self._dec = __import__(\n            \"gnss_sdr_1_tpu.telemetry.gnav\""
        ",\n            fromlist=[\"GnavDecoder\"]).GnavDecoder(slot)") == src_j
    assert tadapt.GlonassChannelDecoder(3).raw.__module__ == \
        "gnss_sdr_1_tpu_torch.telemetry.gnav"


@pytest.mark.parametrize("signal", ["1G", "2S"])
def test_l2c_glonass_scenario_and_generator_identical(signal):
    from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
    from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband as tgen

    if signal == "1G":
        rx = llh_to_ecef(np.radians(55.75), np.radians(37.62), 180.0)
        kw = dict(t0_tow=35995.0, chip_rate=0.511e6,
                  fdma_ks={1: -3, 2: 0, 3: 5})
    else:
        rx, kw = RX, dict(t0_tow=345601.25)
    sj = jscen.build_scenario(rx, [1, 2, 3], duration_s=20.0,
                              cn0_dbhz=47.0, signal=signal, **kw)
    st = tscen.build_scenario(rx, [1, 2, 3], duration_s=20.0,
                              cn0_dbhz=47.0, signal=signal, **kw)
    assert sj.bits_tow0 == st.bits_tow0
    for a, b in zip(sj.sats, st.sats):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_array_equal(da.pop("nav_bits"), db.pop("nav_bits"))
        assert da == db
    for p in (1, 2, 3):
        assert dataclasses.asdict(sj.ephemerides[p]) == \
            dataclasses.asdict(st.ephemerides[p])
    codes = {p: jcodes.tracking_replica(signal, p)[0] for p in (1, 2, 3)}
    spec_j, spec_t = jconst.SIGNALS[signal], tconst.SIGNALS[signal]
    np.testing.assert_array_equal(
        tgen(spec_t, st.sats, codes, 4.092e6, 0.01, noise=True),
        jgen(spec_j, sj.sats, codes, 4.092e6, 0.01, noise=True))


# ---------------------------------------------------------------------------
# BeiDou B1I/B3I: the code and D1/D2 modules, the CGCS2000 orbit branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["codes/beidou.py",
                                 "telemetry/beidou_dnav.py",
                                 "pvt/ephemeris.py"])
def test_beidou_modules_are_copies_and_import_no_jax(rel):
    """The B1I/B3I code generators, the D1/D2 NAV module and the Keplerian
    propagator (with its CGCS2000 branch) are the JAX package's modules,
    byte for byte, and each imports nothing of JAX or of the JAX package
    (test_port_imports_no_jax walks every file; this names them)."""
    path = ROOT / "gnss_sdr_1_tpu_torch" / rel
    assert path.read_text() == (ROOT / "gnss_sdr_1_tpu" / rel).read_text()
    assert path in _port_sources()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
            if node.level == 0:
                assert names[0].split(".")[0] in (
                    "__future__", "dataclasses", "functools", "numpy"), \
                    f"{rel}: {names[0]}"
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "gnss_sdr_1_tpu"), f"{rel}: {name}"


def test_beidou_cgcs2000_orbit_identical():
    """The `C` branch of pvt/ephemeris.py: a CGCS2000 ephemeris of the B1
    scenario gives the JAX package's position, velocity and clock, value
    for value, and differs from the same orbit on WGS-84 constants."""
    import gnss_sdr_1_tpu.pvt.ephemeris as jeph
    import gnss_sdr_1_tpu_torch.pvt.ephemeris as teph

    kw = dict(t0_tow=345601.25, duration_s=12.0, cn0_dbhz=48.0,
              chip_rate=2.046e6, carrier_freq=tconst.FREQ_B1I, signal="B1")
    sj = jscen.build_scenario(RX, [6, 9], **kw)
    st = tscen.build_scenario(RX, [6, 9], **kw)
    for p in (6, 9):
        ej, et = sj.ephemerides[p], st.ephemerides[p]
        assert et.system == ej.system == "C"
        assert type(et).__module__ == \
            "gnss_sdr_1_tpu_torch.telemetry.beidou_dnav"
        for t in (345601.25, 345607.0, 345612.5):
            pj, vj = jeph.satellite_position_velocity(ej, t)
            pt, vt = teph.satellite_position_velocity(et, t)
            np.testing.assert_array_equal(pt, pj)
            np.testing.assert_array_equal(vt, vj)
            assert teph.satellite_clock_correction(et, t) == \
                jeph.satellite_clock_correction(ej, t)
            assert tsolver.sat_clock(et, t) == jsolver.sat_clock(ej, t)
            wgs = dataclasses.replace(et, system="G")
            assert np.linalg.norm(
                teph.satellite_position_velocity(wgs, t)[0] - pt) > 1e-3


# ---------------------------------------------------------------------------
# The LabSat and network sources, the monitor records and sinks, the
# telecommand server and the dump files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["io/labsat.py", "io/network.py",
                                 "runtime/monitor.py",
                                 "runtime/telecommand.py",
                                 "runtime/dumps.py"])
def test_io_and_runtime_host_modules_are_copies(rel):
    """The LabSat and network sources, the Gnss_Synchro records and UDP
    sinks, the telecommand server and the dump writers are the JAX
    package's modules, byte for byte (network.py's one relative import,
    `.formats`, is the port's own copy), and each imports only the
    standard library, numpy and, for the optional .mat export, scipy."""
    path = ROOT / "gnss_sdr_1_tpu_torch" / rel
    assert path.read_text() == (ROOT / "gnss_sdr_1_tpu" / rel).read_text()
    assert path in _port_sources()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
            if node.level:
                assert names == ["formats"], f"{rel}: .{names[0]}"
                continue
        else:
            continue
        for name in names:
            assert name.split(".")[0] in (
                "__future__", "dataclasses", "json", "numpy", "os",
                "pathlib", "scipy", "socket", "struct", "threading"), \
                f"{rel}: {name}"
