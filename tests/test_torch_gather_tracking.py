"""tests/test_tracking.py's tracking cases on the port's gather engine,
through `TrackingEngine.track_block` on the CPU (convergence and code
phase, FLL pull-in, extended coherent integration at 30 dB-Hz, the pilot
secondary wipe with the four-quadrant PLL, lock loss), at that file's
bars, on shorter captures where the behaviour settles sooner; and
`track_block` itself: the gather engine's against the JAX gather
engine's, the chunked engine's against its own `track_capture`."""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import NH20, gps_l1ca_code
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS_T = 4e6


def _track(x, prn, acq_delay, acq_dop, n_ch=1, **cfg_kw):
    cfg = TrackConfig(fs_hz=FS_T, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=n_ch, correlator="gather", **cfg_kw)
    eng = TrackingEngine(cfg, np.stack([gps_l1ca_code(prn)] * n_ch),
                         device="cpu")
    st = eng.init_state()
    st = eng.activate_channel(st, 0, 0, acq_delay, acq_dop, 0, 0)
    base, nmax = 40000, cfg.epoch_samples_max
    outs = {"dop": [], "cn0": [], "corr": [], "start": []}
    pos = 0
    while pos + base + nmax <= len(x):
        st, out = eng.track_block(x[pos: pos + base + nmax], st, base)
        v = out.valid[:, 0]
        outs["dop"] += list(out.carrier_doppler_hz[:, 0][v])
        outs["cn0"] += list(out.cn0_dbhz[:, 0][v])
        outs["corr"] += list(out.correlators[:, 0, :][v])
        outs["start"] += list(out.start[:, 0][v] + pos)
        pos += base
    return st, {k: np.asarray(v) for k, v in outs.items()}


def _gps_signal(prn, doppler, delay, cn0, duration, seed, bits=None,
                spec=None):
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA

    kw = {} if bits is None else {"nav_bits": bits}
    return generate_baseband(
        spec or GPS_L1_CA, [SatParams(prn=prn, doppler_hz=doppler,
                                      delay_chips=delay, cn0_dbhz=cn0,
                                      **kw)],
        {prn: gps_l1ca_code(prn)}, FS_T, duration, noise=True, seed=seed)


def test_track_block_convergence_and_code_phase():
    td, tdc, cn0 = 1777.0, 300.6, 45.0
    x = _gps_signal(1, td, tdc, cn0, 0.6, 11)
    st, o = _track(x, 1, tdc / 1.023e6 * FS_T + 1.0, td + 30.0)
    assert bool(st.active[0])
    assert abs(np.mean(o["dop"][-100:]) - td) < 5.0
    assert np.mean(o["cn0"][-50:]) > cn0 - 4.0
    # epoch starts on the signal's code-period boundaries
    t_prn = FS_T * 1023 / (1.023e6 * (1 + td / 1575.42e6))
    delay_samples = tdc / 1.023e6 * FS_T
    resid = np.mod(o["start"][-50:] - delay_samples + t_prn / 2, t_prn) \
        - t_prn / 2
    assert np.abs(resid).max() < 2.0


def test_track_block_fll_pull_in():
    td, tdc = -3100.0, 700.0
    rng = np.random.default_rng(3)
    x = _gps_signal(7, td, tdc, 44, 1.2, 12,
                    bits=rng.choice([-1.0, 1.0], size=80))
    st, o = _track(x, 7, tdc / 1.023e6 * FS_T, td + 200.0,
                   enable_fll_pull_in=True, pull_in_time_s=0.25)
    assert bool(st.active[0])
    assert abs(np.mean(o["dop"][-100:]) - td) < 5.0


def test_track_block_extended_coherent_low_cn0():
    """States 3/4: 20 ms coherent extension with the narrow bandwidths
    holds a 30 dB-Hz signal, windows on the bit grid."""
    td, tdc, cn0 = 800.0, 512.0, 30.0
    rng = np.random.default_rng(21)
    x = _gps_signal(5, td, tdc, cn0, 2.5, 22,
                    bits=rng.choice([-1.0, 1.0], size=200))
    cfg = TrackConfig(fs_hz=FS_T, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=1, extend_correlation_symbols=20,
                      correlator="gather")
    eng = TrackingEngine(cfg, gps_l1ca_code(5)[None, :], device="cpu")
    st = eng.init_state()
    st = eng.activate_channel(st, 0, 0, tdc / 1.023e6 * FS_T, td + 25.0, 0,
                              0)
    base, nmax = 40000, cfg.epoch_samples_max
    n_epochs, pos, extended = 0, 0, False
    dop, cn0s = [], []
    while pos + base + nmax <= len(x):
        st, out = eng.track_block(x[pos: pos + base + nmax], st, base)
        v = out.valid[:, 0]
        dop += list(out.carrier_doppler_hz[:, 0][v])
        cn0s += list(out.cn0_dbhz[:, 0][v])
        n_epochs += int(v.sum())
        pos += base
        if not extended and n_epochs > 500:
            st = eng.enable_extended(st, 0, (20 - n_epochs % 20) % 20)
            extended = True
    assert bool(st.active[0])
    assert int(st.mode[0]) == 1
    assert abs(np.mean(dop[-200:]) - td) < 3.0
    tail = [c for c in cn0s[-100:] if c > 0]
    assert abs(np.mean(tail) - cn0) < 4.5


def test_track_block_pilot_secondary_wipe_four_quadrant():
    """In-loop secondary wipe with the four-quadrant PLL: a channel whose
    epochs carry NH20 keeps phase lock through the sign flips once the
    wipe is on; the raw prompts still carry the code."""
    from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA

    spec = dataclasses.replace(GPS_L1_CA, bit_rate_bps=1000.0)
    td, tdc, cn0 = -450.0, 200.0, 38.0
    x = _gps_signal(9, td, tdc, cn0, 1.2, 31, bits=np.tile(NH20, 300),
                    spec=spec)
    cfg = TrackConfig(fs_hz=FS_T, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=1, extend_correlation_symbols=20,
                      correlator="gather")
    eng = TrackingEngine(cfg, gps_l1ca_code(9)[None, :],
                         sec_codes=np.asarray(NH20, np.float32)[None, :],
                         device="cpu")
    st = eng.init_state()
    st = eng.activate_channel(st, 0, 0, tdc / 1.023e6 * FS_T, td - 20.0, 0,
                              0)
    base, nmax = 40000, cfg.epoch_samples_max
    n_epochs, pos, enabled = 0, 0, False
    dop, prompts = [], []
    while pos + base + nmax <= len(x):
        st, out = eng.track_block(x[pos: pos + base + nmax], st, base)
        v = out.valid[:, 0]
        dop += list(out.carrier_doppler_hz[:, 0][v])
        prompts += list(out.correlators[:, 0, 1].real[v])
        n_epochs += int(v.sum())
        pos += base
        if not enabled and n_epochs > 400:
            st = eng.enable_extended(st, 0, (20 - n_epochs % 20) % 20,
                                     sec_phase=n_epochs % 20)
            enabled = True
    assert bool(st.active[0]) and bool(st.sec_on[0])
    assert abs(np.mean(dop[-200:]) - td) < 3.0
    tail = np.sign(prompts[-400:])
    t0 = n_epochs - len(tail)
    pattern = np.array([NH20[(t0 + i) % 20] for i in range(len(tail))])
    agree = np.mean(tail * pattern > 0)
    assert agree > 0.9 or agree < 0.1


def test_track_block_lock_loss_releases_channel():
    x1 = _gps_signal(1, 500.0, 10.0, 45, 0.4, 5)
    rng = np.random.default_rng(6)
    n2 = int(FS_T * 0.6)
    x2 = ((rng.standard_normal(n2) + 1j * rng.standard_normal(n2))
          * np.sqrt(0.5)).astype(np.complex64)
    st, _ = _track(np.concatenate([x1, x2]), 1, 10.0 / 1.023e6 * FS_T,
                   500.0, max_lock_fail=20)
    assert not bool(st.active[0])


def _block_engines(correlator, **kw):
    cfg = dict(fs_hz=FS_T, code_length_chips=1023,
               chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
               n_channels=1, chunk_epochs=8, **kw)
    return cfg, TrackingEngine(TrackConfig(correlator=correlator, **cfg),
                               gps_l1ca_code(3)[None, :], device="cpu")


def test_gather_track_block_matches_jax_block():
    """The gather engine's `track_block` against the JAX gather engine's
    (JAX engine.py:1512-1532) on one 40,000-sample block: the same epochs,
    starts, Dopplers and rebased state."""
    import jax.numpy as jnp

    from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
    from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
    from gnss_sdr_1_tpu.utils.planar import to_planar

    td, tdc = 1234.0, 400.2
    x = _gps_signal(3, td, tdc, 45.0, 0.02, 13)
    cfg, et = _block_engines("gather")
    ej = JEngine(JTrackConfig(correlator="gather", **cfg),
                 gps_l1ca_code(3)[None, :])
    args = (0, 0, tdc / 1.023e6 * FS_T, td, 0, 0)
    sj = ej.activate_channel(ej.init_state(), *args)
    s_t = et.activate_channel(et.init_state(), *args)
    base = 40000
    blk = x[: base + et.cfg.epoch_samples_max]
    sj, oj = ej.track_block(jnp.asarray(to_planar(blk)), sj, base)
    s_t, ot = et.track_block(blk, s_t, base)
    vj = np.asarray(oj.valid)
    assert ot.valid.shape == vj.shape == (base // (et._t0_int - 2) + 2, 1)
    np.testing.assert_array_equal(ot.valid, vj)
    np.testing.assert_array_equal(ot.start[vj], np.asarray(oj.start)[vj])
    np.testing.assert_allclose(ot.carrier_doppler_hz[vj],
                               np.asarray(oj.carrier_doppler_hz)[vj],
                               rtol=0, atol=2e-2)
    assert int(s_t.start[0]) == int(np.asarray(sj.start)[0])


def test_chunked_track_block_matches_track_capture():
    """The chunked engine's `track_block` (whole chunks of the block's
    epochs, every row at full rate) against the same engine's
    `track_capture` over the same span (whose state rows it decimates),
    itself held to the JAX engine by tests/test_torch_engine.py."""
    td, tdc = 1234.0, 400.2
    x = _gps_signal(3, td, tdc, 45.0, 0.02, 13)
    _, et = _block_engines("chunked")
    st = et.activate_channel(et.init_state(), 0, 0, tdc / 1.023e6 * FS_T,
                             td, 0, 0)
    base = 40000
    blk = x[: base + et.cfg.epoch_samples_max]
    sb, ob = et.track_block(blk, st, base)
    sc, oc = et.track_capture(torch.from_numpy(blk), st, base)
    assert ob.valid.shape[0] % 8 == 0
    for name in ("valid", "start", "cur_len", "rem_code_phase_samples",
                 "active"):
        np.testing.assert_array_equal(getattr(ob, name), getattr(oc, name),
                                      err_msg=name)
    np.testing.assert_array_equal(ob.correlators, oc.correlators)
    d = et.capture_decim
    np.testing.assert_array_equal(ob.carrier_doppler_hz[d - 1::d],
                                  oc.carrier_doppler_hz[d - 1::d])
    assert int(sb.start[0]) == int(sc.start[0])
