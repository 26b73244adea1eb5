"""The port's gather multicorrelator (ops/multicorrelator.py) and Kalman
tracking engine (track/kf.py) on the CPU against the JAX package's, on the
same numpy inputs made from seeds, and the KF receiver path.

Bars (ROADMAP.md, "Engine, one capture"): valid, start and cur_len exact;
Doppler, code delta and rem code phase at atol 2e-2; correlators and
rem_carr_phase_rad at 1e-4 of their scale.  The KF closes its loop every
epoch, so float32 rounding differences between XLA and torch (sum order,
transcendentals) carry from epoch to epoch; where an epoch's code phase
sits on the sample grid at an integer number of samples per chip, such a
difference can move the floor resampler by one sample at many chip edges at
once.  The engine cases therefore start each channel's code phase half a
sample off the grid, with Dopplers that keep it there over the run."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.ops.multicorrelator import multicorrelate as jmc
from gnss_sdr_1_tpu.ops.multicorrelator import multicorrelate_batch as jmcb
from gnss_sdr_1_tpu.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu.track import kf as jkf
from gnss_sdr_1_tpu_torch.ops.multicorrelator import multicorrelate as tmc
from gnss_sdr_1_tpu_torch.track import kf as tkf
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 4.092e6
CONF_DIR = pathlib.Path(__file__).resolve().parent.parent / "conf"


# ---------------------------------------------------------------------------
# multicorrelator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 3e-9])
@pytest.mark.parametrize("n_valid", [None, 3990])
def test_multicorrelate_matches_jax(rate, n_valid):
    rng = np.random.default_rng(11)
    C, N = 3, 4094
    x = ((rng.standard_normal((C, N)) + 1j * rng.standard_normal((C, N)))
         * 30.0).astype(np.complex64)
    codes = np.stack([gps_l1ca_code(p) for p in (1, 7, 22)])
    shifts = np.asarray([-0.5, 0.0, 0.5], np.float32)
    step = np.float32(1.023e6 / FS) * (1 + rng.uniform(-1e-6, 1e-6, C))
    rem = rng.uniform(-0.3, 0.9, C)
    phase = rng.uniform(0, 6.2, C)
    cstep = rng.uniform(-0.005, 0.005, C)
    crate = np.full(C, rate)
    nv = np.full(C, float(n_valid or N))
    args = [np.asarray(a, np.float32)
            for a in (step, rem, phase, cstep, crate, nv)]
    import torch

    want = np.asarray(jmcb(jnp.asarray(x), jnp.asarray(codes),
                           jnp.asarray(shifts), *map(jnp.asarray, args)))
    got = tmc(torch.as_tensor(x), torch.as_tensor(codes),
              torch.as_tensor(shifts),
              *(torch.as_tensor(a) for a in args[:4]),
              carr_rate_rad=torch.as_tensor(args[4]),
              n_valid=None if n_valid is None else torch.as_tensor(args[5]))
    got = got.numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    # one channel, scalar loop parameters
    w1 = np.asarray(jmc(jnp.asarray(x[0]), jnp.asarray(codes[0]),
                        jnp.asarray(shifts), *(a[0] for a in args[:5]),
                        n_valid=None if n_valid is None else args[5][0]))
    g1 = tmc(torch.as_tensor(x[0]), torch.as_tensor(codes[0]),
             torch.as_tensor(shifts), *(float(a[0]) for a in args[:5]),
             n_valid=None if n_valid is None else float(args[5][0])).numpy()
    assert g1.shape == (3,)
    assert np.abs(g1 - w1).max() <= 1e-5 * np.abs(w1).max()


# ---------------------------------------------------------------------------
# the KF engine
# ---------------------------------------------------------------------------


def _jax_state_numpy(st) -> dict:
    out = {}
    for k, v in st._asdict().items():
        if k == "code_filter":
            out[k] = (np.asarray(v.inputs), np.asarray(v.outputs))
        else:
            out[k] = np.asarray(v)
    return out


def _engines(n_ch=2, **kw):
    prns = list(range(1, n_ch + 1))
    codes = np.stack([gps_l1ca_code(p) for p in prns])
    base = dict(fs_hz=FS, code_length_chips=1023, chip_rate_chips_s=1.023e6,
                carrier_freq_hz=1575.42e6, n_channels=n_ch, **kw)
    return (jkf.KfTrackingEngine(jkf.KfTrackConfig(**base), codes),
            tkf.KfTrackingEngine(tkf.KfTrackConfig(**base), codes,
                                 device="cpu"))


def test_kf_config_and_activation_match_jax():
    for kw in (dict(order=2), dict(order=3), dict(order=2, bayes_run=True,
                                                 bayes_nu=3, bayes_kappa=2)):
        ej, et = _engines(**kw)
        assert dataclasses.asdict(ej.cfg) == dataclasses.asdict(et.cfg)
        np.testing.assert_array_equal(np.asarray(ej._F), et._F.numpy())
        np.testing.assert_array_equal(np.asarray(ej._Q), et._Q.numpy())
        np.testing.assert_array_equal(ej._P0, et._P0)
        assert (ej._t0_int, ej._t0_frac, ej._win) == (
            et._t0_int, et._t0_frac, et._win)
        sj, st = ej.init_state(), et.init_state()
        sj = ej.activate_channel(sj, 1, 1, 1234.56, -2130.0, 100, 4000,
                                 doppler_step_hz=250.0)
        st = et.activate_channel(st, 1, 1, 1234.56, -2130.0, 100, 4000,
                                 doppler_step_hz=250.0)
        sj = ej.deactivate_channel(ej.activate_channel(
            sj, 0, 0, 17.25, 800.0, 0, 0), 0)
        st = et.deactivate_channel(et.activate_channel(
            st, 0, 0, 17.25, 800.0, 0, 0), 0)
        nj, nt = _jax_state_numpy(ej.rebase(sj, 5)), tkf.kf_state_to_numpy(
            et.rebase(st, 5))
        assert set(nj) == set(nt)
        for k in nj:
            if k == "code_filter":
                for a, b in zip(nj[k], nt[k]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(nj[k], nt[k], err_msg=k)
        # the numpy layout round-trips
        back = tkf.kf_state_to_numpy(tkf.kf_state_from_numpy(nj, "cpu"))
        for k in nj:
            if k != "code_filter":
                np.testing.assert_array_equal(back[k], nj[k], err_msg=k)


def _circ(a, b):
    d = np.abs(np.asarray(a, np.float64) - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("order,bayes,duration", [
    (2, False, 0.1), (3, False, 0.2), (2, True, 0.2)])
def test_kf_track_block_matches_jax(order, bayes, duration):
    prns = [1, 2]
    codes = {p: gps_l1ca_code(p) for p in prns}
    # code phases half a sample off the grid (see the module docstring)
    sats = [SatParams(prn=p, doppler_hz=20.0 + 100.0 * i,
                      doppler_rate_hz_s=10.0 if order == 3 else 0.0,
                      delay_chips=100.125 + 300.0 * i, cn0_dbhz=45.0)
            for i, p in enumerate(prns)]
    x = generate_baseband(GPS_L1_CA, sats, codes, FS, duration, noise=True)
    ej, et = _engines(order=order, bayes_run=bayes)
    sj = ej.init_state()
    for ch, s in enumerate(sats):
        sj = ej.activate_channel(sj, ch, ch, s.delay_chips / 1.023e6 * FS,
                                 s.doppler_hz, 0, 0, doppler_step_hz=250.0)
    st = tkf.kf_state_from_numpy(_jax_state_numpy(sj), "cpu")
    base = len(x) - ej.cfg.epoch_samples_max
    sj2, oj = ej.track_block(x, sj, base)
    st2, ot = et.track_block(x, st, base)

    v = np.asarray(oj.valid)
    np.testing.assert_array_equal(ot.valid, v)
    assert v.sum() >= 0.95 * duration * 1e3 * len(prns)
    for name in ("start", "cur_len", "active"):
        np.testing.assert_array_equal(getattr(ot, name),
                                      np.asarray(getattr(oj, name)), name)
    for name in ("carrier_doppler_hz", "code_freq_delta",
                 "rem_code_phase_samples", "doppler_rate_hz_s"):
        np.testing.assert_allclose(getattr(ot, name)[v],
                                   np.asarray(getattr(oj, name))[v],
                                   rtol=0, atol=2e-2, err_msg=name)
    cj = np.asarray(oj.correlators)
    cj = cj[..., 0] + 1j * cj[..., 1]
    assert np.abs(ot.correlators - cj).max() <= 1e-4 * np.abs(cj).max()
    rc = np.asarray(oj.rem_carr_phase_rad)
    assert _circ(ot.rem_carr_phase_rad[v], rc[v]).max() <= 1e-4 * 2 * np.pi
    for name in ("cn0_dbhz", "carr_phase_sigma2"):
        np.testing.assert_allclose(getattr(ot, name)[v],
                                   np.asarray(getattr(oj, name))[v],
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    # the carried state after the block (rebased by `base`)
    nj, nt = _jax_state_numpy(sj2), tkf.kf_state_to_numpy(st2)
    for k in ("active", "prn_slot", "start", "cur_len", "hist_count",
              "lock_fail", "epochs"):
        np.testing.assert_array_equal(nt[k], nj[k], err_msg=k)
    np.testing.assert_allclose(nt["x"][:, 1:], nj["x"][:, 1:], rtol=0,
                               atol=2e-2)


def test_kf_low_cn0_drops_channel_like_jax():
    """tests/test_kf_tracking.py::test_kf_low_cn0_drops_channel: on pure
    noise both engines drop the channel at the same epoch."""
    ej, et = _engines(n_ch=1, order=2, max_lock_fail=1)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=300_000) + 1j * rng.normal(size=300_000)).astype(
        np.complex64)
    sj = ej.activate_channel(ej.init_state(), 0, 0, 100.0, 0.0, 0, 0)
    st = tkf.kf_state_from_numpy(_jax_state_numpy(sj), "cpu")
    sj2, oj = ej.track_block(x, sj, 280_000)
    st2, ot = et.track_block(x, st, 280_000)
    assert not bool(np.asarray(sj2.active)[0])
    assert not bool(st2.active[0])
    np.testing.assert_array_equal(ot.active, np.asarray(oj.active))
    np.testing.assert_array_equal(ot.valid, np.asarray(oj.valid))


# ---------------------------------------------------------------------------
# the KF receiver path
# ---------------------------------------------------------------------------


def test_kalman_conf_builds_kf_receiver():
    from gnss_sdr_1_tpu.runtime.config import FileConfiguration as JConf
    from gnss_sdr_1_tpu.runtime.config import to_receiver_config as jrc
    from gnss_sdr_1_tpu_torch.runtime import Receiver
    from gnss_sdr_1_tpu_torch.runtime.config import FileConfiguration
    from gnss_sdr_1_tpu_torch.runtime.config import to_receiver_config

    path = str(CONF_DIR / "gps_l1_kalman.conf")
    cfg = to_receiver_config(FileConfiguration(path))
    assert cfg.track_engine == jrc(JConf(path)).track_engine == "kf"
    rx = Receiver(cfg, device="cpu")
    assert rx.trk_kind == "kf"
    assert isinstance(rx.trk, tkf.KfTrackingEngine)
    assert rx.trk.cfg.fs_hz == 2.6e6 and rx.trk.cfg.n_channels == 8


def test_kf_receiver_matches_jax():
    """Both receivers with the KF tracker on the same 2.6 Msps capture (the
    gps_l1_kalman.conf rate, 2.54 samples per chip) starting at a subframe
    head: the same assignments, acquisition, bit sync, symbol counts and
    per-bit prompt signs."""
    from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
    from gnss_sdr_1_tpu.runtime import ReceiverConfig as JReceiverConfig
    from gnss_sdr_1_tpu.siggen.scenario import build_scenario
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    fs, prns = 2.6e6, [3, 8]
    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    scen = build_scenario(rx_ecef, prns, t0_tow=345606.1, duration_s=2.5,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(GPS_L1_CA, scen.sats,
                          {p: gps_l1ca_code(p) for p in prns}, fs, 2.5,
                          noise=True)
    kw = dict(fs_hz=fs, n_channels=2, prn_search=tuple(prns),
              track_engine="kf")
    rj = JReceiver(JReceiverConfig(**kw))
    rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    rt.process(x)
    assert rt.channel_prn == rj.channel_prn and None not in rt.channel_prn
    for prn, (dj, fj, sj) in rj._acq_info.items():
        dt, ft, st = rt._acq_info[prn]
        assert ft == fj and st == sj and abs(dt - dj) <= 1.0, prn
    assert rt.sym_count == rj.sym_count
    for prn, dj in rj.decoders.items():
        dt = rt.decoders[prn]
        assert dt.bit_offset == dj.bit_offset is not None, prn
        pj = np.asarray(dj._sym.prompt_i)
        pt = np.asarray(dt._sym.prompt_i)
        b0 = dj.bit_offset
        n = (len(pj) - b0) // 20
        assert n > 50 and len(pt) == len(pj)
        np.testing.assert_array_equal(
            np.sign(pt[b0:b0 + 20 * n].reshape(n, 20).sum(axis=1)),
            np.sign(pj[b0:b0 + 20 * n].reshape(n, 20).sum(axis=1)))


@pytest.mark.slow
def test_kf_first_fix_timing_matches_jax():
    """The KF receiver of the CLI's KF run (12 satellites, 30 s at
    4.092 Msps, live LNAV, PVT every 100 ms, 12 channels, 32 PRNs
    searched) in both packages on the CPU: the same channel assignments
    and symbol counts, the same first-fix time and fix count, positions
    inside the 5 m bar.  Both fix first ~22.5 s into the capture."""
    from test_torch_capture_cache import cached_capture

    from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu.runtime.receiver import Receiver as JReceiver
    from gnss_sdr_1_tpu.runtime.receiver import ReceiverConfig as JCfg
    from gnss_sdr_1_tpu.siggen.scenario import build_scenario
    from gnss_sdr_1_tpu_torch.runtime.receiver import Receiver as TReceiver
    from gnss_sdr_1_tpu_torch.runtime.receiver import \
        ReceiverConfig as TCfg

    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    prns = list(range(1, 13))
    scen = build_scenario(rx_ecef, prns, t0_tow=345601.25, duration_s=30.0,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = cached_capture(
        "kf_e2e_4092000_30_v1",
        lambda: generate_baseband(GPS_L1_CA, scen.sats,
                                  {p: gps_l1ca_code(p) for p in prns}, FS,
                                  30.0, noise=True))
    kw = dict(fs_hz=FS, signal_id="1C", n_channels=12, track_engine="kf",
              pvt_output_rate_ms=100)
    rj = JReceiver(JCfg(**kw))
    sj = rj.process(x)
    rt = TReceiver(TCfg(**kw), device="cpu")
    st = rt.process(x)
    assert rt.channel_prn == rj.channel_prn
    assert rt.sym_count == rj.sym_count
    assert len(st) == len(sj) >= 10
    assert st[0].rx_time_tow_s == pytest.approx(sj[0].rx_time_tow_s,
                                                abs=1e-6)
    e3d = np.linalg.norm(np.stack([s.rx_ecef_m for s in st]) - rx_ecef,
                         axis=1)
    assert np.median(e3d) < 5.0
