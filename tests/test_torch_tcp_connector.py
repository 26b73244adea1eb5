"""The port's TCP-connector tracking (track/tcp_connector.py): the loop
closure in an external process over TCP, the JAX package's
tests/test_tcp_connector.py cases on the port, and the port's tracker rows
against the JAX package's tracker rows on the same capture, each tracker
talking to its own package's LoopClosureServer.  The per-epoch correlation
runs through the plain multicorrelator here (`device="cpu"`); on the card
through `multicorrelate_cuda` (chip_smoke.py phase 27)."""

import numpy as np
import pytest

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track.tcp_connector import (LoopClosureServer,
                                                      TcpConnectorTracking,
                                                      TcpTrackConfig)
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
TRUE_DOP = 820.0


@pytest.fixture(scope="module")
def capture():
    return generate_baseband(
        GPS_L1_CA,
        [SatParams(prn=3, doppler_hz=TRUE_DOP, delay_chips=257.3,
                   cn0_dbhz=50.0)],
        {3: gps_l1ca_code(3)}, FS, 1.2, noise=True, seed=2)


def _track(mod_trk, mod_srv, cfg_cls, x, n_epochs=1000, stamps=None, **kw):
    srv = mod_srv(pll_bw_hz=20.0, dll_bw_hz=2.0, seed_doppler_hz=800.0)
    trk = mod_trk(cfg_cls(FS, 1023, 1.023e6, 1575.42e6), gps_l1ca_code(3),
                  "127.0.0.1", srv.port, **kw)
    trk.seed(257.3 / 1.023e6 * FS, 800.0)
    try:
        if stamps is not None:
            return trk.track(x, n_epochs, stamps)
        return trk.track(x, n_epochs)
    finally:
        trk.close()
        srv.close()


def test_tcp_connector_closes_the_loop_externally(capture):
    rows = _track(TcpConnectorTracking, LoopClosureServer, TcpTrackConfig,
                  capture, device="cpu")
    assert len(rows) >= 900
    tail = np.array([r["doppler_hz"] for r in rows[-100:]])
    # the EXTERNAL controller pulled the 20 Hz seed error in
    assert abs(tail.mean() - TRUE_DOP) < 3.0, tail.mean()
    # prompt power coherent at the end (code loop also closed)
    p_tail = np.array([abs(r["prompt"]) for r in rows[-100:]])
    p_head = np.array([abs(r["prompt"]) for r in rows[:50]])
    assert p_tail.mean() > 0.7 * p_head.mean()


def test_epoch_stamps_split_every_epoch(capture):
    """track() stamps each epoch's parts in order (tcp_connector.
    EPOCH_STAMPS) and takes the capture as a tensor as well, with the same
    rows."""
    import torch

    from gnss_sdr_1_tpu_torch.track.tcp_connector import EPOCH_STAMPS

    stamps = []
    rows = _track(TcpConnectorTracking, LoopClosureServer, TcpTrackConfig,
                  capture, 40, device="cpu", stamps=stamps)
    t = np.asarray(stamps)
    assert t.shape == (40, len(EPOCH_STAMPS))
    assert (np.diff(t, axis=1) >= 0).all() and (t[1:, 0] >= t[:-1, -1]).all()
    again = _track(TcpConnectorTracking, LoopClosureServer, TcpTrackConfig,
                   torch.as_tensor(capture), 40, device="cpu")
    assert again == rows


def test_tracker_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TcpConnectorTracking(TcpTrackConfig(FS, 1023, 1.023e6, 1575.42e6),
                             gps_l1ca_code(3), "127.0.0.1", 1)


def test_factory_routes_tcp_connector():
    from gnss_sdr_1_tpu_torch.runtime.factory import resolve, strategy_impl

    info = resolve("GPS_L1_CA_TCP_CONNECTOR_Tracking")
    assert info.status == "native"
    assert info.strategy == "tcp_connector"
    assert strategy_impl("tracking", "tcp_connector") is TcpConnectorTracking


def test_rows_match_the_jax_tracker(capture):
    """The same capture through both packages' trackers for 300 epochs,
    each against its own package's server (the JAX tracker runs its
    multicorrelator eagerly, ~10 ms an epoch here): the same starts (the
    A.6 recursion runs in float64 on the host in both), Doppler within
    1e-2 Hz and prompts within 1e-4 of their scale (the two correlators
    round the per-sample phase and code index apart in the last bit: JAX
    evaluates them op by op, the port's plain version with fused
    multiply-adds)."""
    from gnss_sdr_1_tpu.track import tcp_connector as jtcp

    rj = _track(jtcp.TcpConnectorTracking, jtcp.LoopClosureServer,
                jtcp.TcpTrackConfig, capture, 300)
    rt = _track(TcpConnectorTracking, LoopClosureServer, TcpTrackConfig,
                capture, 300, device="cpu")
    assert len(rt) == len(rj) == 300
    assert [r["start"] for r in rt] == [r["start"] for r in rj]
    np.testing.assert_allclose([r["doppler_hz"] for r in rt],
                               [r["doppler_hz"] for r in rj], rtol=0,
                               atol=1e-2)
    pj = np.array([r["prompt"] for r in rj])
    pt = np.array([r["prompt"] for r in rt])
    assert np.abs(pt - pj).max() <= 1e-4 * np.abs(pj).max()
