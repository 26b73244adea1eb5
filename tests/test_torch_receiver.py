"""The port's Receiver (device='cpu') against the JAX Receiver
(correlator='mxu', the chunked path the TPU runs, with its chain unrolled in
XLA) on the same capture: the same channel -> PRN assignments, acquisition
Doppler and delay, bit sync and symbol counts, and per-bit prompt signs.
The slow case runs a 24 s capture to fixes: the same fix count, and both
within the system tests' bar (median 3D error < 5 m)."""

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
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)


def _run_both(prns, duration, t0_tow=345601.25, seed=1234, **cfg_kw):
    scen = build_scenario(RX, prns, t0_tow=t0_tow, duration_s=duration,
                          cn0_dbhz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(GPS_L1_CA, scen.sats,
                          {p: gps_l1ca_code(p) for p in prns}, FS, duration,
                          noise=True, seed=seed)
    kw = dict(fs_hz=FS, n_channels=len(prns), prn_search=tuple(prns),
              **cfg_kw)
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    rt.process(x)
    return scen, rj, rt


@pytest.fixture(scope="module")
def short_run():
    # starts at a subframe head (TLM/HOW bits flip often, so bit sync comes
    # early) and spans four equal 1 s segments: every channel is extended
    # and the later segments run the symbol-grid reduction
    return _run_both([3, 8, 14, 22], 4.0 + 2e-3, t0_tow=345606.1)


def test_receiver_refuses_unported_options():
    # ported: the KF tracker on BeiDou B1I, as on every signal
    rx = Receiver(ReceiverConfig(signal_id="B1", track_engine="kf",
                                 prn_search=(6, 7)), device="cpu")
    assert rx.trk_kind == "kf" and rx.trk.cfg.code_length_chips == 2046
    ReceiverConfig(signal_id="B1")            # ported: BeiDou B1I
    ReceiverConfig(signal_id="2S")            # ported: GPS L2C
    ReceiverConfig(signal_id="1G", fdma_k=((1, -7), (2, 6)))  # GLONASS
    with pytest.raises(NotImplementedError):
        ReceiverConfig(track_engine="veml")
    ReceiverConfig(track_engine="kf")         # ported: track/kf.py
    for strategy in ("tong", "quicksync", "fine_doppler"):
        ReceiverConfig(acq_strategy=strategy)  # ported: acquire/
    ReceiverConfig(signal_id="1B", acq_strategy="cccwsr")
    with pytest.raises(ValueError, match="Galileo E5a strategy"):
        Receiver(ReceiverConfig(acq_strategy="caf"), device="cpu")
    # ported: the monitor taps (JAX's fields and defaults)
    cfg = ReceiverConfig(enable_monitor=True, enable_pvt_monitor=True)
    assert (cfg.monitor_host, cfg.monitor_port, cfg.monitor_decimation,
            cfg.pvt_monitor_port) == ("127.0.0.1", 1234, 50, 1111)
    rx = Receiver(cfg, device="cpu")
    assert rx.monitor is not None and rx.pvt_monitor is not None
    rx.monitor.close()
    rx.pvt_monitor.close()


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
        # per-bit prompt sums from the bit boundary agree in sign
        b0 = dj.bit_offset
        n = (len(pj) - b0) // 20
        assert n > 60
        sj = pj[b0:b0 + 20 * n].reshape(n, 20).sum(axis=1)
        st = pt[b0:b0 + 20 * n].reshape(n, 20).sum(axis=1)
        np.testing.assert_array_equal(np.sign(st), np.sign(sj))


@pytest.mark.slow
def test_fixes_match_on_24s_capture():
    scen, rj, rt = _run_both([1, 2, 3, 4, 5, 6], 24.0)
    assert len(rt.solutions) == len(rj.solutions) >= 40
    for rx in (rj, rt):
        e3d = np.linalg.norm(np.stack([s.rx_ecef_m for s in rx.solutions])
                             - scen.rx_ecef, axis=1)
        assert np.median(e3d) < 5.0


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fixes_match_on_24s_capture_other_noise(seed):
    """The 24 s case on other noise realisations: the port's fixes are the
    JAX package's, the same count from the same output epoch, positions
    within 0.5 m of each other.  The 5 m median bar belongs to the seed
    above: on seed 1 both packages' median is ~8 m."""
    scen, rj, rt = _run_both([1, 2, 3, 4, 5, 6], 24.0, seed=seed)
    pj, pt = (np.stack([s.rx_ecef_m for s in rx.solutions])
              for rx in (rj, rt))
    print(f"seed {seed}: {len(pj)} fixes (JAX), {len(pt)} (port), the "
          f"first {rj.solutions[0].rx_time_tow_s - scen.t0_tow:.2f} s into "
          f"the capture; median 3D error "
          f"{np.median(np.linalg.norm(pj - scen.rx_ecef, axis=1)):.2f} m "
          f"(JAX), {np.median(np.linalg.norm(pt - scen.rx_ecef, axis=1)):.2f}"
          f" m (port); max distance between them "
          f"{np.abs(pt - pj).max() if len(pt) == len(pj) else np.nan:.3e} m")
    assert len(pt) == len(pj) > 0
    # the same output epoch (PVT every 100 ms)
    assert rt.solutions[0].rx_time_tow_s == pytest.approx(
        rj.solutions[0].rx_time_tow_s, abs=1e-3)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=0.5)
