"""A-GNSS in the port (runtime/assistance.py, pvt/rinex_reader.py and the
Receiver's set_assistance / assisted acquisition / load_ephemerides)
against the JAX package's, on the CPU.

Host copies are held bit for bit: the assistance JSON is the same text,
the loaded ephemerides and the predictions equal field by field, the
RINEX nav read-back equals the JAX reader's.  The assisted PCPS program
(each satellite's predicted Doppler folded into its replica, the
two-period window) makes the same detections in the same Doppler bin, the
delay within one sample and the statistics within rtol 1e-4, at offsets
that are not a whole number of carrier cycles a window.  The assisted
receiver (the port's chunked path, the JAX package's default gather path)
assigns the same satellites at the same acquisition Doppler and tracks
the same symbol counts, on the cases of tests/test_runtime_aux.py's
assistance tests cut to 0.3 s captures."""

import importlib

import numpy as np
import pytest

from test_torch_precise_ppp_rtk import JAX, PORT, assert_same, modules
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
DUR = 0.3
TOW = 345601.25


def pkgmods(pkg):
    M = modules(pkg)
    for name, mod in (("assist", "runtime.assistance"),
                      ("receiver", "runtime.receiver"),
                      ("rinex", "pvt.rinex_reader"),
                      ("printers", "pvt.printers"), ("acq", "acquire"),
                      ("gnav", "telemetry.gnav"), ("gen", "siggen.generator"),
                      ("codes", "codes")):
        setattr(M, name, importlib.import_module(f"{pkg}.{mod}"))
    return M


def receiver(M, **kw):
    cfg = M.receiver.ReceiverConfig(**kw)
    if M.pkg == PORT:
        return M.receiver.Receiver(cfg, device="cpu")
    return M.receiver.Receiver(cfg)


def rx_ecef(M):
    return M.geo.llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)


@pytest.fixture(scope="module")
def one_sat():
    """tests/test_runtime_aux.py's short capture (one strong GPS L1
    satellite, PRN 7 at 1200 Hz, nav bits that never frame-sync) cut to
    0.3 s."""
    M = pkgmods(PORT)
    return M.gen.generate_baseband(
        M.const.GPS_L1_CA,
        [M.gen.SatParams(prn=7, doppler_hz=1200.0, delay_chips=300.25,
                         cn0_dbhz=48.0)],
        {7: M.codes.gps_l1ca_code(7)}, FS, DUR, noise=True, seed=3)


def _roundtrip_and_visibility(M, tmp_path):
    ephs = {p: M.scen.make_test_ephemeris(
        p, toe=345600.0, plane_raan_deg=-40 + 30 * p, anomaly_deg=30 * p)
        for p in (1, 2, 3)}
    path = tmp_path / f"{M.pkg}.json"
    M.assist.save_assistance(str(path), ephs, ref_llh=(41.0, 2.0, 100.0),
                             ref_tow_s=345600.0)
    ephs2, ref, tow = M.assist.load_assistance(str(path))
    assert set(ephs2) == {1, 2, 3}
    assert ephs2[1].sqrt_a == ephs[1].sqrt_a
    assert ref == (41.0, 2.0, 100.0) and tow == 345600.0
    rx = M.geo.llh_to_ecef(np.radians(41.0), np.radians(2.0), 100.0)
    vis = M.assist.predict_visible(ephs2, rx, 345600.0,
                                   min_elevation_deg=-90.0)
    assert set(vis) == {1, 2, 3}
    for v in vis.values():
        assert abs(v["doppler_hz"]) < 6000.0
    # the warm start from almanac pages alone: the same sky to a degree
    alms = {p: M.lnav.GpsAlmanac(
        prn=p, e=e.e, toa=e.toe, delta_i=e.i0 - 0.30,
        omega_dot=e.omega_dot, sqrt_a=e.sqrt_a, omega0=e.omega0,
        omega=e.omega, m0=e.m0, af0=e.af0, af1=e.af1)
        for p, e in ephs2.items()}
    alm = M.assist.predict_visible_from_almanac(
        alms, rx, 345600.0, week=220, min_elevation_deg=-90.0)
    for p, v in vis.items():
        assert abs(alm[p]["el_deg"] - v["el_deg"]) < 1.0
    return path.read_text(), ephs2, ref, tow, vis, alm


def _rinex_mixed_roundtrip(M, tmp_path):
    g = M.scen.make_test_ephemeris(7, toe=345600.0, plane_raan_deg=40.0,
                                   anomaly_deg=120.0, af0=1.5e-5)
    e = M.scen._gps_to_galileo(M.scen.make_test_ephemeris(
        11, toe=345600.0, plane_raan_deg=-60.0))
    e.iod_nav = 37
    c = M.scen._gps_to_beidou(M.scen.make_test_ephemeris(
        6, toe=345600.0, plane_raan_deg=100.0))
    r = M.gnav.GlonassEphemeris(
        slot=5, freq_channel=-3, tb_s=11700.0, tk_s=11730.0,
        x_km=11000.123, y_km=-12500.456, z_km=17999.789,
        vx_kms=2.5001, vy_kms=1.2002, vz_kms=-0.7003,
        ax_kms2=1.86e-9, gamma_n=1.8e-12, tau_n_s=-6.5e-6, nt_days=500)
    iono = M.lnav.GpsIono(alpha0=1.1e-8, alpha1=-7.45e-9, beta0=90112.0,
                          beta1=-16384.0, valid=True)
    txt = M.printers.rinex_nav_header(iono=iono)
    for eph in (g, e, c, r):
        txt += M.printers.rinex_nav_record(eph)
    assert "GPSA" in txt and "IONOSPHERIC CORR" in txt
    p = tmp_path / f"{M.pkg}.rnx"
    p.write_text(txt)
    back = M.rinex.read_rinex_nav_mixed(str(p))
    bg, be, bc, br = back["G"][7], back["E"][11], back["C"][6], back["R"][5]
    for f in ("sqrt_a", "e", "m0", "omega0", "i0", "omega", "delta_n",
              "omega_dot", "idot", "af0", "af1", "toe"):
        assert getattr(bg, f) == pytest.approx(getattr(g, f), rel=1e-11), f
        assert getattr(be, f) == pytest.approx(getattr(e, f), rel=1e-11), f
        assert getattr(bc, f) == pytest.approx(getattr(c, f), rel=1e-11), f
    assert bg.week == g.week and bg.iodc == g.iodc and bg.tgd == g.tgd
    assert be.iod_nav == 37 and be.wn == e.wn
    assert bc.week == c.week and bc.sat_h1 == c.sat_h1
    for f in ("tb_s", "tk_s", "x_km", "vy_kms", "az_kms2", "tau_n_s",
              "gamma_n", "nt_days", "freq_channel"):
        assert getattr(br, f) == pytest.approx(getattr(r, f), rel=1e-9), f
    # the GPS-only reader of the hot start
    assert M.rinex.read_rinex_nav(str(p)) == back["G"]
    return txt, back


@pytest.mark.parametrize("case", [_roundtrip_and_visibility,
                                  _rinex_mixed_roundtrip],
                         ids=["assistance_json", "rinex_nav_mixed"])
def test_host_copies_match_jax(case, tmp_path):
    """tests/test_runtime_aux.py :55 (the assistance store and the
    visibility prediction, with the almanac warm start beside it) and
    :367 (the RINEX 3.02 nav round trip for all four systems): the same
    text and the same objects, the port's own."""
    assert_same(case(pkgmods(JAX), tmp_path), case(pkgmods(PORT), tmp_path))


# ---------------------------------------------------------------------------
# The assisted program: non-integer cycles a window
# ---------------------------------------------------------------------------

# PRN -> (predicted Doppler, true Doppler): predictions 1234.5 Hz and other
# offsets that are not a whole number of cycles a 1 ms window, each true
# Doppler a residual away from its prediction
OFFSETS = {3: (1234.5, 1334.5), 8: (-2718.3, -2818.3), 14: (377.7, 302.7),
           22: (-61.25, 38.75)}


@pytest.fixture(scope="module")
def offset_capture():
    M = pkgmods(PORT)
    sats = [M.gen.SatParams(prn=p, doppler_hz=f, delay_chips=97.5 + 211 * i,
                            cn0_dbhz=45.0)
            for i, (p, (_pred, f)) in enumerate(OFFSETS.items())]
    return M.gen.generate_baseband(
        M.const.GPS_L1_CA, sats,
        {p: M.codes.gps_l1ca_code(p) for p in OFFSETS}, FS, 0.01,
        noise=True, seed=11)


def _assisted_program(M, x):
    cfg = M.acq.AcqConfig(
        fs_hz=FS, samples_per_code=2046, samples_per_chip=2,
        doppler_max_hz=600.0, doppler_step_hz=250.0, max_dwells=2,
        bit_transition_flag=True, use_cfar=False, threshold=2.0)
    codes = {p: M.codes.gps_l1ca_code(p) for p in OFFSETS}
    kw = dict(fs_code_rate=(1.023e6, 1023),
              freq_offsets_by_prn={p: o[0] for p, o in OFFSETS.items()})
    acq = (M.acq.PcpsAcquisition(cfg, codes, device="cpu", **kw)
           if M.pkg == PORT else M.acq.PcpsAcquisition(cfg, codes, **kw))
    assert acq.prns == sorted(OFFSETS)
    res = acq.acquire(np.asarray(x[:cfg.fft_size * 2]), samplestamp=17)
    return tuple(np.asarray(getattr(res, f)) for f in (
        "positive", "doppler_hz", "delay_samples", "test_stat"))


def test_assisted_program_at_fractional_offsets(offset_capture):
    """The narrowed program (a +-600 Hz grid around each satellite's
    folded prediction, the two-period window) on four satellites whose
    predictions are 1234.5, -2718.3, 377.7 and -61.25 Hz: the port
    detects what the JAX package detects, in the same Doppler bin, the
    delay within a sample and the statistic within rtol 1e-4; the true
    Doppler is the prediction plus the reported residual, to a bin."""
    pj, dj, tj, sj = _assisted_program(pkgmods(JAX), offset_capture)
    pt, dt, tt, st = _assisted_program(pkgmods(PORT), offset_capture)
    np.testing.assert_array_equal(pt, pj)
    assert pt.all()
    np.testing.assert_array_equal(dt, dj)
    dd = np.abs(tt - tj) % 2046
    assert np.minimum(dd, 2046 - dd).max() <= 1.0
    np.testing.assert_allclose(st, sj, rtol=1e-4)
    for k, p in enumerate(sorted(OFFSETS)):
        pred, true = OFFSETS[p]
        assert abs(pred + dt[k] - true) <= 125.0, p


# ---------------------------------------------------------------------------
# The assisted receiver
# ---------------------------------------------------------------------------


def _run(M, x, assist=None, window=600.0, narrow=None, **kw):
    rx = receiver(M, fs_hz=FS, signal_id="1C", n_channels=1,
                  prn_search=(7,), watchdog_symbols=0, **kw)
    if assist is not None:
        rx._assist = assist
        rx._assist_window_hz = window
    if narrow is not None:
        import dataclasses

        cfg = dataclasses.replace(rx._acq_cfg, doppler_max_hz=narrow[1],
                                  bit_transition_flag=True)
        akw = dict(fs_code_rate=rx._fs_code_rate,
                   freq_offsets_by_prn={7: narrow[0]})
        if M.pkg == PORT:
            akw["device"] = "cpu"
        rx._assist_acq = M.acq.PcpsAcquisition(cfg, {7: rx._codes[7]},
                                               **akw)
        assert rx.acq.cfg.num_doppler_bins >= 5 * cfg.num_doppler_bins
    rx.process(x)
    return rx


def assert_same_run(rt, rj):
    """The same channel assignments and symbol counts, each satellite
    acquired at the same Doppler and sample stamp, its delay within a
    sample."""
    assert rt.channel_prn == rj.channel_prn
    assert rt.sym_count == rj.sym_count
    assert list(rt._acq_info) == list(rj._acq_info)
    for p, (dj, fj, sj) in rj._acq_info.items():
        dt, ft, st = rt._acq_info[p]
        assert (ft, st) == (fj, sj), p
        assert abs(dt - dj) <= 1.0, p


@pytest.mark.parametrize("pred,window,want", [
    ({3: {"doppler_hz": 0.0}}, 600.0, None),       # PRN 7 not predicted
    ({7: {"doppler_hz": 1100.0}}, 600.0, 7),       # inside the window
    ({7: {"doppler_hz": -3000.0}}, 600.0, None)],  # a sideband
    ids=["not_visible", "inside_window", "outside_window"])
def test_assistance_gates_cold_grid_like_jax(one_sat, pred, window, want):
    """tests/test_runtime_aux.py :272: with predictions but no narrowed
    program, the cold grid's peaks are gated — a satellite predicted
    below the horizon is never assigned, one inside the window is, one
    outside it is rejected; the port assigns as the JAX receiver does."""
    rj = _run(pkgmods(JAX), one_sat, assist=pred, window=window)
    rt = _run(pkgmods(PORT), one_sat, assist=pred, window=window)
    assert rt.channel_prn[0] == want
    assert_same_run(rt, rj)


def test_assisted_grid_narrows_and_seeds_doppler_like_jax(one_sat):
    """tests/test_runtime_aux.py :305: a hand-built narrowed program (a
    +-500 Hz grid around a prediction 80 Hz off the true 1200 Hz) has at
    least 5x fewer Doppler bins than the cold grid, assigns PRN 7 with the
    prediction added back to the residual, and seeds the engine near the
    truth; the port's assignment, acquisition Doppler and symbol count are
    the JAX receiver's."""
    assist = {7: {"doppler_hz": 1280.0}}
    rj = _run(pkgmods(JAX), one_sat, assist=assist, window=500.0,
              narrow=(1280.0, 500.0))
    rt = _run(pkgmods(PORT), one_sat, assist=assist, window=500.0,
              narrow=(1280.0, 500.0))
    assert rt.channel_prn[0] == 7
    assert_same_run(rt, rj)
    assert abs(rt._acq_info[7][1] - 1200.0) <= 125.0
    dop = float(rt.state.carrier_doppler_hz[0])
    assert abs(dop - 1200.0) < 60.0, dop


def _builds_narrow(M):
    rx = receiver(M, fs_hz=FS, signal_id="1C", n_channels=1, prn_search=(7,))
    scen = M.scen.build_scenario(rx_ecef(M), [7], t0_tow=TOW, duration_s=1.0,
                                 cn0_dbhz=47.0)
    n = rx.set_assistance(scen.ephemerides, rx_ecef(M), TOW, window_hz=600.0)
    assert n == 1 and rx._assist_acq is not None
    assert rx._assist_acq.cfg.doppler_max_hz == 600.0
    assert rx._assist_acq.cfg.bit_transition_flag
    assert rx._assist_acq.prns == [7]
    assert rx._assist_acq.freq_offsets[7] == pytest.approx(
        rx._assist[7]["doppler_hz"])
    return rx._assist, rx._assist_acq.freq_offsets, rx._assist_acq.prns


def test_set_assistance_builds_narrow_program_like_jax():
    """tests/test_runtime_aux.py :343: set_assistance with real
    ephemerides predicts the satellite visible and installs the narrowed
    program with its predicted Doppler folded into the replica, on the
    receiver's device (here the CPU)."""
    assert_same(_builds_narrow(pkgmods(JAX)), _builds_narrow(pkgmods(PORT)))
    M = pkgmods(PORT)
    rx = receiver(M, fs_hz=FS, n_channels=1, prn_search=(7,))
    scen = M.scen.build_scenario(rx_ecef(M), [7], t0_tow=TOW, duration_s=1.0,
                                 cn0_dbhz=47.0)
    rx.set_assistance(scen.ephemerides, rx_ecef(M), TOW)
    assert rx._assist_acq.device == rx.device == rx.acq.device
    assert rx._assist_acq._code_fft_conj.device == rx.device
    # Tong keeps the cold program; assistance builds none for it
    tong = receiver(M, fs_hz=FS, n_channels=1, prn_search=(7,),
                    acq_strategy="tong")
    assert tong.set_assistance(scen.ephemerides, rx_ecef(M), TOW) == 1
    assert tong._assist_acq is None


SKY = [3, 8, 14, 22, 27]


@pytest.fixture(scope="module")
def sky_capture():
    """Five satellites of the receiver's sky at TOW (two of them low), and
    PRNs the assistance predicts below the horizon in the search list."""
    M = pkgmods(PORT)
    scen = M.scen.build_scenario(rx_ecef(M), SKY, t0_tow=TOW,
                                 duration_s=DUR, cn0_dbhz=47.0)
    return M.gen.generate_baseband(
        M.const.GPS_L1_CA, scen.sats,
        {p: M.codes.gps_l1ca_code(p) for p in SKY}, FS, DUR, noise=True,
        seed=1234)


def _assisted_receiver(M, x):
    scen = M.scen.build_scenario(rx_ecef(M), SKY, t0_tow=TOW,
                                 duration_s=DUR, cn0_dbhz=47.0)
    # the reference location 1 km east of the truth
    east = np.array([-np.sin(np.radians(1.988)), np.cos(np.radians(1.988)),
                     0.0])
    rx = receiver(M, fs_hz=FS, n_channels=len(SKY),
                  prn_search=tuple(SKY) + (1, 2, 30, 31),
                  acq_strategy="assisted")
    n = rx.set_assistance(scen.ephemerides, rx_ecef(M) + 1000.0 * east, TOW)
    rx.process(x)
    return n, rx._assist_acq.prns, rx


def test_assisted_receiver_matches_jax(sky_capture):
    """The assisted receiver end to end: `acq_strategy="assisted"`,
    predictions from the scenario's ephemerides at a reference location
    1 km off, the narrowed program holding the visible PRNs only (in its
    own order, not the cold program's): the port assigns the JAX
    receiver's satellites to the JAX receiver's channels at the same
    acquisition Doppler and tracks the same symbol counts."""
    nj, vj, rj = _assisted_receiver(pkgmods(JAX), sky_capture)
    nt, vt, rt = _assisted_receiver(pkgmods(PORT), sky_capture)
    assert (nt, vt) == (nj, vj) and set(SKY) <= set(vt)
    assert vt == sorted(vt) and vt != rt.acq.prns
    assert_same_run(rt, rj)
    assert sorted(p for p in rt.channel_prn if p is not None) == SKY


def _hot_start(M, tmp_path):
    scen = M.scen.build_scenario(rx_ecef(M), [7, 9], t0_tow=TOW,
                                 duration_s=1.0, cn0_dbhz=47.0)
    txt = M.printers.rinex_nav_header() + "".join(
        M.printers.rinex_nav_record(e) for e in scen.ephemerides.values())
    path = tmp_path / f"{M.pkg}_brdc.rnx"
    path.write_text(txt)
    ephs = M.rinex.read_rinex_nav(str(path))
    rx = receiver(M, fs_hz=FS, n_channels=2, prn_search=(7, 9))
    assert rx._eph_for(7) is None
    rx.load_ephemerides(ephs)
    assert rx._eph_for(7) is rx.assist_ephemerides[7]
    assert rx._eph_for(5) is None
    return ephs, rx._eph_for(9)


def test_hot_start_ephemerides_like_jax(tmp_path):
    """load_ephemerides (the hot start of a RINEX nav file read by
    read_rinex_nav): _eph_for falls back to the loaded ephemeris while a
    channel's decoder has none, as the JAX receiver does."""
    assert_same(_hot_start(pkgmods(JAX), tmp_path),
                _hot_start(pkgmods(PORT), tmp_path))


def _resumed_assistance(M, tmp_path):
    rx = receiver(M, fs_hz=FS, n_channels=1, prn_search=(7,))
    scen = M.scen.build_scenario(rx_ecef(M), [7], t0_tow=TOW, duration_s=1.0,
                                 cn0_dbhz=47.0)
    rx.set_assistance(scen.ephemerides, rx_ecef(M), TOW)
    rx.load_ephemerides(scen.ephemerides)
    path = tmp_path / f"{M.pkg}.ckpt"
    rx.checkpoint(str(path))
    cls = M.receiver.Receiver
    back = (cls.resume_from(str(path), device="cpu") if M.pkg == PORT
            else cls.resume_from(str(path)))
    assert "_assist" not in cls._CKPT_FIELDS
    return (getattr(back, "_assist", None), back._assist_acq,
            getattr(back, "assist_ephemerides", {}), back._eph_for(7))


def test_assistance_is_not_checkpointed_like_jax(tmp_path):
    """Neither package's checkpoint carries the assistance: a resumed
    receiver has no predictions, no narrowed program and no hot-start
    ephemerides until they are given again."""
    want = _resumed_assistance(pkgmods(JAX), tmp_path)
    got = _resumed_assistance(pkgmods(PORT), tmp_path)
    assert want == (None, None, {}, None)
    assert got == want
