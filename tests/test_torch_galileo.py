"""The port's Galileo E1B path against the JAX package's, on the CPU.

- The code tables (`codes/data/icd_tables.npz`), the E1B/E1C memory codes,
  CS25 and the sinBOC(1,1) tracking replica, element for element.
- The 5-tap (VE/E/P/L/VL) chunked engine against the JAX engine with
  `correlator='mxu'` from the same mid-track state, carried across through
  state_from_numpy (a [C, 5] accumulator): the engine bars of ROADMAP.md
  (valid, start and cur_len exact; Doppler, rem code and rem carrier phase
  at atol 2e-2; the fields the JAX package ships as f16 at f16
  resolution).
- A 1B Receiver on a 0.8 s, 3-satellite capture (the JAX receiver takes
  ~40 s per second of this signal on the CPU): the same assignments,
  acquisition results and symbol counts; and each acquisition strategy the
  receiver dispatches for 1B on the same samples: the same assignments,
  Doppler bins, delays within 1 sample and statistics to rtol 1e-4.
- Galileo `solve_pvt` on the E1 scenario's I/NAV ephemerides, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnss_sdr_1_tpu.codes as jcodes
from gnss_sdr_1_tpu.codes.data import tables as jtables
from gnss_sdr_1_tpu.constants import GALILEO_E1B as JE1B
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
from gnss_sdr_1_tpu.runtime import ReceiverConfig as JReceiverConfig
from gnss_sdr_1_tpu.siggen import SatParams
from gnss_sdr_1_tpu.siggen.generator import generate_baseband
from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
from gnss_sdr_1_tpu.utils.planar import to_planar
import gnss_sdr_1_tpu_torch.codes as tcodes
from gnss_sdr_1_tpu_torch.codes.data import tables as ttables
from gnss_sdr_1_tpu_torch.constants import GALILEO_E1B as TE1B
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy, state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 4.0e6               # not commensurate with the 2.046 MHz virtual rate
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
N_CH = 3
KW = dict(fs_hz=FS, code_length_chips=4092, chip_rate_chips_s=1.023e6,
          carrier_freq_hz=1575.42e6, n_channels=N_CH, code_samples_per_chip=2,
          veml=True, early_late_space_chips=0.15,
          very_early_late_space_chips=0.6, pll_bw_hz=15.0, dll_bw_hz=2.0,
          chunk_epochs=8)
F16_RTOL = 2.0 ** -10        # one f16 ulp, relative


def _virtual_spec():
    """Generation spec: the sinBOC 'virtual' code at 2.046e6 chips/s, one
    I/NAV symbol per 4 ms code period (tests/test_system_galileo.py)."""
    return dataclasses.replace(JE1B, code_rate_chips_s=2.046e6,
                               code_length_chips=2 * 4092, bit_rate_bps=250.0)


def _leaves(st):
    return {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in st._asdict().items()}


# ---------------------------------------------------------------------------
# codes and tables
# ---------------------------------------------------------------------------


def test_icd_tables_identical():
    tj, tt = jtables(), ttables()
    assert sorted(tt) == sorted(tj)
    for k in tj:
        assert tt[k].dtype == tj[k].dtype, k
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
    np.testing.assert_array_equal(tcodes.E1C_SECONDARY, jcodes.E1C_SECONDARY)
    assert tcodes.E1C_SECONDARY.shape == (25,)
    assert dataclasses.asdict(TE1B) == dataclasses.asdict(JE1B)


@pytest.mark.parametrize("prn", range(1, 51))
def test_e1_codes_and_replica_identical(prn):
    for gen in ("galileo_e1b_code", "galileo_e1c_code"):
        a, b = getattr(jcodes, gen)(prn), getattr(tcodes, gen)(prn)
        assert a.dtype == b.dtype and a.shape == b.shape == (4092,)
        np.testing.assert_array_equal(a, b, err_msg=gen)
    np.testing.assert_array_equal(tcodes.generate_code("1B", prn),
                                  jcodes.generate_code("1B", prn))
    ra, rb = jcodes.tracking_replica("1B", prn), tcodes.tracking_replica(
        "1B", prn)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:] == (2.046e6, 2)
    np.testing.assert_array_equal(
        tcodes.galileo_e1_sinboc11(tcodes.galileo_e1c_code(prn)),
        jcodes.galileo_e1_sinboc11(jcodes.galileo_e1c_code(prn)))


# ---------------------------------------------------------------------------
# the 5-tap engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def veml_setup():
    rng = np.random.default_rng(8)
    prns = (4, 11, 19)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, 8184)), cn0_dbhz=47.0,
                      nav_bits=rng.choice([-1.0, 1.0], size=60))
            for p in prns]
    codes = np.stack([jcodes.tracking_replica("1B", p)[0] for p in prns])
    x = generate_baseband(_virtual_spec(), sats,
                          {p: codes[k] for k, p in enumerate(prns)}, FS,
                          0.2, noise=True, seed=4)
    ej = JEngine(JTrackConfig(correlator="mxu", **KW), codes)
    et = TrackingEngine(TrackConfig(**KW), codes, device="cpu")
    st = ej.init_state()
    for ch, s in enumerate(sats):
        st = ej.activate_channel(st, ch, ch, s.delay_chips / 2.046e6 * FS,
                                 s.doppler_hz, 0, 0)
    # 48 ms of JAX tracking gives the mid-track state both engines start
    # from
    head = int(FS * 0.048)
    st, _ = ej.track_capture(jnp.asarray(to_planar(x)), st, head)
    return ej, et, x[head:], _leaves(st)


def test_veml_tables_and_state_round_trip(veml_setup):
    ej, et, _, leaves = veml_setup
    assert et.chain_spec.K == 5 and et.chain_spec.prompt_index == 2
    np.testing.assert_array_equal(np.asarray(ej._rep_rows), et.rep_rows_np)
    assert et._lag_window == ej._lag_window
    assert leaves["acc_corr"].shape == (N_CH, 5, 2)
    back = state_to_numpy(state_from_numpy(leaves, "cpu"))
    assert set(back) == set(leaves)
    for k, v in leaves.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        back[k] if isinstance(v, tuple) else (back[k],)):
            np.testing.assert_array_equal(a, b, err_msg=k)


def _state_from_jax(leaves):
    from gnss_sdr_1_tpu.track.engine import TrackState
    from gnss_sdr_1_tpu.track.loop_filter import FllPllState, IirState

    d = dict(leaves)
    d["carr_filter"] = FllPllState(*(jnp.asarray(a)
                                     for a in d["carr_filter"]))
    d["code_filter"] = IirState(*(jnp.asarray(a) for a in d["code_filter"]))
    return TrackState(**{k: (v if k in ("carr_filter", "code_filter")
                             else jnp.asarray(v)) for k, v in d.items()})


def _close_f16(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=atol,
                               err_msg=what)


def test_veml_track_capture_matches_jax(veml_setup):
    ej, et, x, leaves = veml_setup
    span = int(FS * 0.12)
    st_j, oj = ej.track_capture(jnp.asarray(to_planar(x)),
                                _state_from_jax(leaves), span)
    st_t, ot = et.track_capture(torch.from_numpy(x),
                                state_from_numpy(leaves, "cpu"), span)
    np.testing.assert_array_equal(ot.valid, oj.valid)
    v = oj.valid
    assert v.sum() >= 0.9 * 30 * N_CH
    np.testing.assert_array_equal(ot.start[v], oj.start[v])
    np.testing.assert_array_equal(ot.cur_len[v], oj.cur_len[v])
    np.testing.assert_array_equal(ot.active, oj.active)
    assert ot.active[-1].all()
    for name in ("carrier_doppler_hz", "rem_code_phase_samples",
                 "rem_carr_phase_rad"):
        np.testing.assert_allclose(getattr(ot, name)[v],
                                   getattr(oj, name)[v], rtol=0, atol=2e-2,
                                   err_msg=name)
    _close_f16(ot.code_freq_delta[v], oj.code_freq_delta[v], 2e-2, "delta")
    _close_f16(ot.cn0_dbhz[v], oj.cn0_dbhz[v], 2e-2, "cn0")
    # the JAX package ships the prompt (tap 2 of VE/E/P/L/VL) only, as f16
    pj = oj.correlators[..., 2, 0] + 1j * oj.correlators[..., 2, 1]
    pt = ot.correlators[..., 2]
    _close_f16(pt.real[v], pj.real[v], 2e-2, "prompt I")
    _close_f16(pt.imag[v], pj.imag[v], 2e-2, "prompt Q")
    sj, stn = _leaves(st_j), state_to_numpy(st_t)
    for name in ("start", "cur_len", "push_count", "active"):
        np.testing.assert_array_equal(stn[name], sj[name], err_msg=name)
    for name in ("carrier_doppler_hz", "code_freq_delta",
                 "rem_code_phase_samples"):
        np.testing.assert_allclose(stn[name], sj[name], rtol=0, atol=2e-2,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the receiver
# ---------------------------------------------------------------------------


def _scenario(prns, duration):
    from gnss_sdr_1_tpu.siggen.scenario import build_scenario

    scen = build_scenario(RX, list(prns), t0_tow=345601.25,
                          duration_s=duration, cn0_dbhz=48.0,
                          chip_rate=2.046e6, signal="1B")
    codes = {p: jcodes.tracking_replica("1B", p)[0] for p in prns}
    x = generate_baseband(_virtual_spec(), scen.sats, codes, FS, duration,
                          noise=True)
    return scen, x


@pytest.fixture(scope="module")
def e1_capture():
    return _scenario((1, 3, 5), 0.8)


def _cfg_kw(prns, **kw):
    return dict(fs_hz=FS, signal_id="1B", n_channels=len(prns),
                prn_search=tuple(prns), acq_dwells=3, pll_bw_hz=15.0,
                dll_bw_hz=2.0, **kw)


def test_receiver_matches_jax(e1_capture):
    _, x = e1_capture
    kw = _cfg_kw((1, 3, 5))
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    rt.process(x)
    assert rt.trk.chain_spec.K == 5
    assert rt.channel_prn == rj.channel_prn
    assert None not in rt.channel_prn
    assert set(rt._acq_info) == set(rj._acq_info)
    for prn, (dj, fj, sj) in rj._acq_info.items():
        dt, ft, st = rt._acq_info[prn]
        assert ft == fj, prn
        assert abs(dt - dj) <= 1.0, prn
        assert st == pytest.approx(sj, rel=1e-4), prn
    assert rt.sym_count == rj.sym_count
    assert min(rt.sym_count.values()) > 150      # 4 ms symbols, 0.8 s
    # no coherent extension and no symbol-grid readback on E1B
    assert list(rt._mode_host) == list(rj._mode_host) == [0] * 3
    assert rt._symbol_offsets() is None
    for prn, dj in rj.decoders.items():
        # the soft I/NAV symbols handed to the decoder agree in sign once
        # the loops are through pull-in (the first 100 symbols, 0.4 s)
        pj = np.asarray(dj.raw._soft)
        pt = np.asarray(rt.decoders[prn].raw._soft)
        assert pt.shape == pj.shape and len(pt) > 150, prn
        np.testing.assert_array_equal(np.sign(pt[100:]), np.sign(pj[100:]))
        assert rt.decoders[prn].raw.page_sync == dj.raw.page_sync


# CCCWSR and 8 ms normalise their peak by F^2 times the input power, not
# by the noise floor: their detections need a threshold on that scale
_THRESHOLDS = {"cccwsr": 8e-4, "8ms": 8e-4}


@pytest.mark.parametrize("strategy", ["pcps", "tong", "quicksync", "cccwsr",
                                      "fine_doppler", "8ms"])
def test_acquisition_strategies_match_jax(e1_capture, strategy):
    """The receiver's acquisition dispatch for 1B, on the capture's first
    0.2 s: the same channel assignments, Doppler, delays and samplestamps
    as the JAX receiver.  For fine-Doppler the JAX receiver cannot assign
    (its FineDopplerAcquisition returns the Doppler as a [1, C] row when
    more than one PRN is searched, and receiver.py:520 indexes it per PRN),
    so the port's assignments are held to the JAX acquisition's result."""
    _, x = e1_capture
    prns = (1, 3, 5, 7)
    kw = _cfg_kw(prns, acq_strategy=strategy,
                 acq_threshold=_THRESHOLDS.get(strategy, 2.0))
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    assert rt.acq_strategy == rj.acq_strategy == strategy
    assert type(rt.acq).__name__ == type(rj.acq).__name__
    head = x[: int(FS * 0.2)]
    rt._acquire_and_assign(0, head)
    # the three satellites (QuickSync's statistic at threshold 2 also
    # passes on noise: the reference's own conf value)
    assert {1, 3, 5} <= set(rt.channel_prn)
    if strategy == "fine_doppler":
        res = rj.acq.acquire(head)
        want = {p: (float(res.delay_samples[k]),
                    float(np.ravel(res.doppler_hz)[k]), 0)
                for k, p in enumerate(rj.acq.prns) if res.positive[k]}
    else:
        rj._acquire_and_assign(0, head)
        assert rt.channel_prn == rj.channel_prn
        want = rj._acq_info
    assert set(rt._acq_info) == set(want)
    spc = rt.samples_per_code
    for prn, (dj, fj, sj) in want.items():
        dt, ft, st = rt._acq_info[prn]
        assert ft == pytest.approx(fj, abs=1e-6), prn
        dd = abs(dt - dj) % spc
        assert min(dd, spc - dd) <= 1.0, prn
        assert st == sj, prn


def test_caf_and_unported_refused():
    from gnss_sdr_1_tpu_torch.runtime.config import ROADMAP_ITEMS

    # the CAF is an E5a strategy: off E5a the config builds and the
    # receiver raises the JAX package's ValueError
    cfg = ReceiverConfig(signal_id="1B", acq_strategy="caf")
    with pytest.raises(ValueError, match="noncoherent-IQ CAF acquisition "
                       "is a Galileo E5a strategy"):
        Receiver(cfg, device="cpu")
    # L5, E5a, GPS L2C, GLONASS and BeiDou are ported, and the KF tracker
    # runs on every signal: on E1B in the virtual half-chip basis (the
    # sinBOC replica at 2.046 MHz, 8184 half-chips), as the JAX receiver
    # builds it
    for sid in ("2S", "1G", "2G", "B1", "B3"):
        ReceiverConfig(signal_id=sid)
    ReceiverConfig(signal_id="5X", acq_strategy="caf")
    for sid, prn in (("1B", 1), ("L5", 1), ("5X", 11), ("B1", 6)):
        rx = Receiver(ReceiverConfig(signal_id=sid, track_engine="kf",
                                     prn_search=(prn,)), device="cpu")
        assert rx.trk_kind == "kf"
        spc = 2 if sid == "1B" else 1
        assert rx.trk.cfg.code_length_chips == rx.cfg.spec.code_length_chips \
            * spc
        assert rx.trk.cfg.chip_rate_chips_s == pytest.approx(
            rx.cfg.spec.code_rate_chips_s * spc)
        assert rx.trk.cfg.early_late_space_chips == \
            rx.cfg.early_late_space_chips * spc
    # assisted acquisition is ported: the config builds, and a strategy
    # neither package has is refused as the signals item
    assert ReceiverConfig(signal_id="1B",
                          acq_strategy="assisted").acq_strategy == "assisted"
    with pytest.raises(NotImplementedError, match="no item"):
        ReceiverConfig(signal_id="1B", acq_strategy="no_such_strategy")
    assert "JAX package has no such one" in ROADMAP_ITEMS["signals"]
    assert "acquisition" not in ROADMAP_ITEMS
    with pytest.raises(ValueError, match="Galileo E1"):
        Receiver(ReceiverConfig(acq_strategy="cccwsr"), device="cpu")


# ---------------------------------------------------------------------------
# PVT
# ---------------------------------------------------------------------------


def test_galileo_solve_pvt_identical():
    import gnss_sdr_1_tpu.pvt.solver as jsolver
    import gnss_sdr_1_tpu.siggen.scenario as jscen
    import gnss_sdr_1_tpu.telemetry.inav as jinav
    import gnss_sdr_1_tpu_torch.pvt.solver as tsolver
    import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
    import gnss_sdr_1_tpu_torch.telemetry.inav as tinav

    prns = [1, 2, 3, 4, 5, 6]
    kw = dict(t0_tow=345601.25, duration_s=4.0, cn0_dbhz=48.0,
              chip_rate=2.046e6, signal="1B")
    sj = jscen.build_scenario(RX, prns, **kw)
    st = tscen.build_scenario(RX, prns, **kw)
    assert sj.bits_tow0 == st.bits_tow0
    for a, b in zip(sj.sats, st.sats):
        assert (a.prn, a.doppler_hz, a.delay_chips) == (
            b.prn, b.doppler_hz, b.delay_chips)
        np.testing.assert_array_equal(a.nav_bits, b.nav_bits)
    # the I/NAV broadcast fields, converted as the channel decoder converts
    # them for the solver (system 'E')
    ej = {p: jinav.to_keplerian(jscen._gps_to_galileo(sj.ephemerides[p]))
          for p in prns}
    et = {p: tinav.to_keplerian(tscen._gps_to_galileo(st.ephemerides[p]))
          for p in prns}
    t = sj.t0_tow + 1.0
    rng = np.random.default_rng(3)
    prs = {p: jscen.observed_delay_s(sj.ephemerides[p], RX, t) * 299792458.0
           + 900.0 + rng.normal() * 2.0 for p in prns}
    dops = {p: sj.truth[p]["doppler_hz"] for p in prns}
    a = jsolver.solve_pvt(ej, prs, t, dopplers_hz=dops, el_mask_deg=5.0,
                          weighted=True)
    b = tsolver.solve_pvt(et, prs, t, dopplers_hz=dops, el_mask_deg=5.0,
                          weighted=True)
    assert a.valid and b.valid and a.n_sats == b.n_sats == len(prns)
    np.testing.assert_array_equal(a.rx_ecef_m, b.rx_ecef_m)
    np.testing.assert_array_equal(a.rx_vel_ecef_ms, b.rx_vel_ecef_ms)
    assert a.rx_clock_bias_s == b.rx_clock_bias_s
    assert np.linalg.norm(b.rx_ecef_m - RX) < 20.0


def test_galileo_ephemeris_constants():
    """Keplerian Galileo ephemerides (system 'E') propagate with the JAX
    package's constants, as do BeiDou's (system 'C', CGCS2000)."""
    from types import SimpleNamespace

    from gnss_sdr_1_tpu.pvt.ephemeris import _gm_omega as jgm
    from gnss_sdr_1_tpu_torch.constants import (BDS_GM,
                                                BDS_OMEGA_EARTH_DOT)
    from gnss_sdr_1_tpu_torch.pvt.ephemeris import _gm_omega as tgm

    for system in ("G", "E", "C"):
        eph = SimpleNamespace(system=system)
        assert tgm(eph) == jgm(eph)
    assert tgm(SimpleNamespace(system="C")) == (BDS_GM, BDS_OMEGA_EARTH_DOT)
    assert tgm(SimpleNamespace(system="E")) != tgm(
        SimpleNamespace(system="C"))


@pytest.mark.slow
def test_fixes_match_jax_on_system_scenario():
    """tests/test_system_galileo.py's scenario (5 satellites, 18 s at
    4 Msps) through the chunked path of both packages (the JAX receiver with
    correlator='mxu', the port on the CPU): the same ephemerides, the same
    fix count, the same positions within 0.5 m.  The chunked path reads the
    taps by linear interpolation between integer-sample lags, which on the
    narrow sinBOC(1,1) peak at ~2 samples per chip costs metres: its median
    3D error here is under 12 m, where the JAX package's exact per-epoch
    path (the system test's default) stays under 5 m."""
    scen, x = _scenario((1, 2, 3, 4, 5), 18.0)
    kw = _cfg_kw((1, 2, 3, 4, 5))
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    sj = rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    st = rt.process(x)
    assert len(st) == len(sj) >= 10
    assert {p for p, d in rt.decoders.items() if d.ephemeris_complete} == \
        {p for p, d in rj.decoders.items() if d.ephemeris_complete}
    pj = np.stack([s.rx_ecef_m for s in sj])
    pt = np.stack([s.rx_ecef_m for s in st])
    assert np.linalg.norm(pt - pj, axis=1).max() < 0.5
    med = np.median(np.linalg.norm(pt - scen.rx_ecef, axis=1))
    print(f"chunked path on the E1 system scenario: {len(st)} fixes, "
          f"median 3D error {med:.2f} m")
    assert med < 12.0


def test_inav_decoder_resyncs():
    """The port's I/NAV decoder where the JAX package's copy fails: a
    stream that starts in the even part of a page (the JAX decoder syncs on
    the odd part and never decodes), and a half-cycle slip that flips the
    symbols' sign mid-stream (the JAX decoder re-finds its first sync,
    re-decodes up to the slip and loops there for ever).  Both decode the
    whole ephemeris and the GST TOW of the scenario."""
    import time

    import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
    from gnss_sdr_1_tpu_torch.telemetry.channel_adapters import \
        GalileoChannelDecoder

    scen = tscen.build_scenario(RX, [4], t0_tow=345601.25, duration_s=20.0,
                                cn0_dbhz=48.0, chip_rate=2.046e6,
                                signal="1B")
    bits = np.asarray(scen.sats[0].nav_bits)
    rng = np.random.default_rng(6)
    soft = bits * 80.0 + rng.normal(size=len(bits)) * 10.0
    flipped = soft.copy()
    flipped[2600:] *= -1.0                # a slip inside the sixth page
    for what, stream in (("even start", soft[37:]),
                         ("slip", flipped[287:])):
        dec = GalileoChannelDecoder(4)
        t0 = time.perf_counter()
        for k in range(0, len(stream), 250):
            dec.push(stream[k:k + 250])
        assert time.perf_counter() - t0 < 20.0, what
        assert dec.ephemeris_complete, what
        assert dec.ephemeris.sqrt_a == pytest.approx(
            scen.ephemerides[4].sqrt_a, abs=2e-5), what
        assert dec.tow_at_symbol(0) is not None, what
