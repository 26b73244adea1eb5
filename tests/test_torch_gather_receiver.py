"""The port's Receiver on the gather correlator (device='cpu',
`correlator='gather'`) against the JAX Receiver with its default
`correlator='auto'`, which is the gather path on the CPU, on
tests/test_torch_receiver.py's captures: the same channel -> PRN
assignments, bit sync, symbol counts and per-bit prompt signs on the 4 s
capture; the slow case runs its 24 s capture to fixes (the same fix count
from the same output epoch, positions a median 5 cm and at most 0.5 m
apart, both within the system tests' median 3D bar of 5 m)."""

import numpy as np
import pytest

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
from gnss_sdr_1_tpu.runtime import ReceiverConfig as JReceiverConfig
from gnss_sdr_1_tpu.siggen.generator import generate_baseband
from gnss_sdr_1_tpu.siggen.scenario import build_scenario
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.runtime.receiver import tracking_correlator
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)


def _run_both(prns, duration, t0_tow=345601.25, seed=1234):
    scen = build_scenario(RX, prns, t0_tow=t0_tow, duration_s=duration,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(GPS_L1_CA, scen.sats,
                          {p: gps_l1ca_code(p) for p in prns}, FS, duration,
                          noise=True, seed=seed)
    kw = dict(fs_hz=FS, n_channels=len(prns), prn_search=tuple(prns))
    rj = JReceiver(JReceiverConfig(**kw))
    assert rj.correlator == "gather"          # JAX 'auto' off the TPU
    rj.process(x)
    rt = Receiver(ReceiverConfig(correlator="gather", **kw), device="cpu")
    assert rt.trk.correlator == "gather"
    rt.preload(x)
    rt.process(x)
    return scen, rj, rt


@pytest.fixture(scope="module")
def short_run():
    # tests/test_torch_receiver.py's 4 s capture: a subframe head, four
    # 1 s segments, every channel extended and the later segments on the
    # symbol-grid reduction
    return _run_both([3, 8, 14, 22], 4.0 + 2e-3, t0_tow=345606.1)


def test_correlator_names_map_as_documented():
    assert tracking_correlator("auto") == "chunked"
    for name in ("chunked", "pallas", "mxu"):
        assert tracking_correlator(name) == "chunked"
    assert tracking_correlator("gather") == "gather"
    with pytest.raises(ValueError, match="Does not carry over"):
        ReceiverConfig(correlator="fft")
    with pytest.raises(ValueError):
        ReceiverConfig(correlator="nope")
    rx = Receiver(ReceiverConfig(prn_search=(1, 2), n_channels=2),
                  device="cpu")
    assert rx.correlator == rx.trk.correlator == "chunked"


def test_same_assignments_and_acquisition(short_run):
    _, rj, rt = short_run
    assert rt.channel_prn == rj.channel_prn
    assert None not in rt.channel_prn
    assert set(rt._acq_info) == set(rj._acq_info)
    for prn, (dj, fj, sj) in rj._acq_info.items():
        dt, ft, st = rt._acq_info[prn]
        assert ft == fj, prn
        assert abs(dt - dj) <= 1.0, prn
        assert st == sj, prn


def test_same_bit_sync_and_symbols(short_run):
    _, rj, rt = short_run
    assert rt.sym_count == rj.sym_count
    assert list(rt._mode_host) == list(rj._mode_host) == [1, 1, 1, 1]
    assert rt._symbol_offsets() is not None
    for prn, dj in rj.decoders.items():
        dt = rt.decoders[prn]
        assert dt.bit_offset == dj.bit_offset is not None, prn
        pj = np.asarray(dj._sym.prompt_i)
        pt = np.asarray(dt._sym.prompt_i)
        assert len(pt) == len(pj)
        b0 = dj.bit_offset
        n = (len(pj) - b0) // 20
        assert n > 60
        sj = pj[b0:b0 + 20 * n].reshape(n, 20).sum(axis=1)
        st = pt[b0:b0 + 20 * n].reshape(n, 20).sum(axis=1)
        np.testing.assert_array_equal(np.sign(st), np.sign(sj))


@pytest.mark.slow
def test_fixes_match_on_24s_capture():
    """The 24 s capture: the same fixes from the same output epoch,
    positions a median 5 cm and at most 0.5 m apart (the CLI comparison's
    bar, tests/test_torch_cli.py; measured on the CPU: 1.5 cm median, 16 cm
    at most, growing over the capture), both medians under 5 m (1.54 m
    JAX, 1.52 m port).  The two gather paths part from the first epoch:
    their correlators differ in the last bits (XLA's float32 sine, cosine
    and dot products round otherwise than torch's on the CPU;
    tests/test_torch_kf.py::test_multicorrelate_matches_jax holds them
    within 1e-5 relative, not bit for bit), and the closure keeps the
    chain's rounding of the carrier step (a true division by fs and an
    unfused multiply-add, where XLA multiplies by the reciprocal and
    fuses).  The loops carry those differences until an epoch's length
    differs by one sample, and from then on the channels' noise
    trajectories differ."""
    scen, rj, rt = _run_both([1, 2, 3, 4, 5, 6], 24.0)
    assert len(rt.solutions) == len(rj.solutions) >= 40
    assert rt.solutions[0].rx_time_tow_s == pytest.approx(
        rj.solutions[0].rx_time_tow_s, abs=1e-3)
    pj, pt = (np.stack([s.rx_ecef_m for s in rx.solutions])
              for rx in (rj, rt))
    d = np.linalg.norm(pt - pj, axis=1)
    assert np.median(d) < 0.05 and d.max() < 0.5
    for p in (pj, pt):
        assert np.median(np.linalg.norm(p - scen.rx_ecef, axis=1)) < 5.0


# ---------------------------------------------------------------------------
# longer agreement checks (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_long_track_matches_jax_gather_engine():
    """Four GPS channels over 3 s from the truth, both packages' gather
    engines from the same state: the long-track bars of
    tools/ab_pallas_tpu.py:105-111 (converged-tail Doppler within 1 Hz,
    epoch starts within 2 samples, CN0 mean |diff| under 0.7 dB) over more
    than 10,000 common epochs."""
    import jax.numpy as jnp
    import torch

    from gnss_sdr_1_tpu.siggen import SatParams
    from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
    from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
    from gnss_sdr_1_tpu.utils.planar import to_planar
    from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
    from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy

    fs, n_ch, dur = 4.092e6, 4, 3.0
    rng = np.random.default_rng(8)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=44.0,
                      nav_bits=rng.choice([-1.0, 1.0], int(dur * 50) + 4))
            for p in range(1, n_ch + 1)]
    codes = np.stack([gps_l1ca_code(p) for p in range(1, n_ch + 1)])
    x = generate_baseband(GPS_L1_CA, sats, {p: codes[p - 1]
                                            for p in range(1, n_ch + 1)},
                          fs, dur + 0.01, noise=True, seed=9)
    kw = dict(fs_hz=fs, code_length_chips=1023, chip_rate_chips_s=1.023e6,
              carrier_freq_hz=1575.42e6, n_channels=n_ch,
              correlator="gather")
    ej = JEngine(JTrackConfig(**kw), codes)
    et = TrackingEngine(TrackConfig(**kw), codes, device="cpu")
    sj = ej.init_state()
    for ch, s in enumerate(sats):
        sj = ej.activate_channel(sj, ch, ch, s.delay_chips / 1.023e6 * fs,
                                 s.doppler_hz, 0, 0)
    leaves = {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                  else np.asarray(v)) for k, v in sj._asdict().items()}
    # 1 s segments, each engine carrying its own state across them, as a
    # receiver calls the engines (one compiled JAX program for all three)
    span = int(fs)
    nmax = et.cfg.epoch_samples_max
    st = state_from_numpy(leaves, "cpu")
    outs_j, outs_t = [], []
    for k in range(int(dur)):
        seg = x[k * span:k * span + span + nmax]
        sj, o = ej.track_capture(jnp.asarray(to_planar(seg)), sj, span)
        outs_j.append(o)
        st, o = et.track_capture(torch.from_numpy(seg), st, span)
        outs_t.append(o)

    def cat(outs, name):
        return np.concatenate([np.asarray(getattr(o, name)) for o in outs])

    oj, ot = ({n: cat(outs, n) for n in ("valid", "start",
                                         "carrier_doppler_hz", "cn0_dbhz")}
              for outs in (outs_j, outs_t))
    for o in (oj, ot):
        seg_id = np.repeat(np.arange(len(outs_j)),
                           len(o["start"]) // len(outs_j))
        o["start"] = o["start"].astype(np.int64) + seg_id[:, None] * span
    oj, ot = (type("Outs", (), o) for o in (oj, ot))
    v = oj.valid & ot.valid
    assert v.sum() > 10_000
    assert np.abs(ot.start[v].astype(np.int64)
                  - oj.start[v].astype(np.int64)).max() <= 2
    dj = np.where(oj.valid, oj.carrier_doppler_hz, np.nan)
    dt = np.where(ot.valid, ot.carrier_doppler_hz, np.nan)
    tail = np.abs(np.nanmean(dj[-200:], axis=0)
                  - np.nanmean(dt[-200:], axis=0))
    assert np.nanmax(tail) < 1.0
    sel = v & (oj.cn0_dbhz > 0) & (ot.cn0_dbhz > 0)
    assert np.abs(oj.cn0_dbhz[sel] - ot.cn0_dbhz[sel]).mean() < 0.7


def _system_run(signal):
    """tests/test_system_galileo.py's or tests/test_system_beidou.py's
    5-satellite scenario as those tests build it (the port's host copies),
    through the port's Receiver on the gather path on the CPU."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.codes import BEIDOU_NH20, tracking_replica
    from gnss_sdr_1_tpu_torch.constants import GALILEO_E1B, SIGNALS
    from gnss_sdr_1_tpu_torch.siggen.generator import \
        generate_baseband as tgen
    from gnss_sdr_1_tpu_torch.siggen.scenario import \
        build_scenario as tscen

    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    fs = 4.0e6
    if signal == "1B":
        prns, dur = [1, 2, 3, 4, 5], 18.0
        scen = tscen(rx_ecef, prns, t0_tow=345601.25, duration_s=dur,
                     cn0_dbhz=48.0, chip_rate=2.046e6, signal="1B")
        spec = dataclasses.replace(GALILEO_E1B, code_rate_chips_s=2.046e6,
                                   code_length_chips=2 * 4092,
                                   bit_rate_bps=250.0)
        cfg = ReceiverConfig(fs_hz=fs, signal_id="1B", n_channels=5,
                             prn_search=tuple(prns), acq_dwells=3,
                             pll_bw_hz=15.0, dll_bw_hz=2.0,
                             correlator="gather")
    else:
        prns, dur = [6, 7, 8, 9, 10], 24.0
        b1 = SIGNALS["B1"]
        scen = tscen(rx_ecef, prns, t0_tow=345601.25, duration_s=dur,
                     cn0_dbhz=48.0, chip_rate=2.046e6,
                     carrier_freq=b1.carrier_freq_hz, signal="B1")
        spec = dataclasses.replace(b1, bit_rate_bps=1000.0)
        for s in scen.sats:
            s.nav_bits = np.repeat(s.nav_bits, 20) * np.tile(
                BEIDOU_NH20, len(s.nav_bits))
        cfg = ReceiverConfig(fs_hz=fs, signal_id="B1", n_channels=5,
                             prn_search=tuple(prns), acq_dwells=3,
                             acq_bit_transition=True, pll_bw_hz=18.0,
                             dll_bw_hz=2.0, early_late_space_chips=0.2,
                             doppler_step2_hz=15.0,
                             num_doppler_bins_step2=40, correlator="gather")
    codes = {p: tracking_replica(signal, p)[0] for p in prns}
    x = tgen(spec, scen.sats, codes, fs, dur, noise=True)
    rx = Receiver(cfg, device="cpu")
    rx.preload(x)
    return scen, rx, rx.process(x)


@pytest.mark.slow
@pytest.mark.parametrize("signal", ["1B", "B1"])
def test_system_scenario_on_the_gather_path(signal):
    """The Galileo E1B and BeiDou B1I system tests' 5-satellite scenarios
    at their bars through the port's gather path: >= 4 complete
    ephemerides with sqrt_a within 2e-5 of the truth, >= 10 fixes, median
    3D error and mean-bias norm under 5 m (both packages' chunked paths
    give 10.05 m and 33.82 m there; ROADMAP.md §3)."""
    scen, rx, sols = _system_run(signal)
    ephs = {p: d.ephemeris for p, d in rx.decoders.items()
            if d.ephemeris_complete}
    assert len(ephs) >= 4
    for p, e in ephs.items():
        assert e.sqrt_a == pytest.approx(scen.ephemerides[p].sqrt_a,
                                         abs=2e-5)
    assert len(sols) >= 10
    errs = np.stack([s.rx_ecef_m - scen.rx_ecef for s in sols])
    assert np.median(np.linalg.norm(errs, axis=1)) < 5.0
    assert np.linalg.norm(errs.mean(axis=0)) < 5.0


@pytest.mark.parametrize("name, runs", [
    ("auto", "chunked"), ("chunked", "chunked"), ("gather", "gather"),
    ("mxu", "chunked"), ("pallas", "chunked")])
def test_tracking_engine_takes_every_receiver_correlator_name(name, runs):
    # TrackConfig.correlator takes the names ReceiverConfig.correlator
    # takes, mapped through tracking_correlator (ROADMAP.md §3, deliberate
    # differences: the port's default stays 'chunked', JAX's is 'gather')
    cfg = TrackConfig(fs_hz=FS, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=2, correlator=name)
    eng = TrackingEngine(cfg, np.stack([gps_l1ca_code(1), gps_l1ca_code(2)]),
                         device="cpu")
    assert eng.correlator == runs
    assert (eng.corr_spec if runs == "chunked" else eng.gather_spec).C == 2
    assert TrackConfig(FS, 1023, 1.023e6, 1575.42e6).correlator == "chunked"


def test_tracking_engine_refuses_fft():
    cfg = TrackConfig(fs_hz=FS, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=1, correlator="fft")
    with pytest.raises(ValueError, match="Does not carry over"):
        TrackingEngine(cfg, gps_l1ca_code(1)[None], device="cpu")
