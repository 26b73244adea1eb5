"""The channel-sharded engine on the card (no JAX here: the GPU machine
runs this file with `--noconftest -m gpu`): four logical shards of cuda:0,
each on its own stream, equal row for row to the unsharded engine on the
card, on both correlators, their per-epoch rows and their symbol grids
(each shard's reduction kernel and its one read on its own stream); the
sharded acquisition grid likewise."""

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.acquire import AcqConfig, PcpsAcquisition
from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.parallel import (ChannelShardedAcquisition,
                                           ChannelShardedEngine,
                                           channel_mesh,
                                           gather_channel_tree)
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_to_numpy

FS = 4.092e6
N_CH = 8
PRNS = list(range(1, N_CH + 1))


@pytest.fixture(scope="module")
def capture():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=46.0)
            for p in PRNS]
    codes = np.stack([gps_l1ca_code(p) for p in PRNS])
    x = generate_baseband(GPS_L1_CA, sats, dict(zip(PRNS, codes)), FS, 0.2,
                          noise=True)
    return sats, codes, x


def _same(got, want):
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("correlator", ["chunked", "gather"])
def test_logical_gpu_shards_equal_unsharded(capture, correlator):
    sats, codes, x = capture
    cfg = TrackConfig(fs_hz=FS, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=N_CH, correlator=correlator)
    eng = TrackingEngine(cfg, codes, device="cuda:0")
    sen = ChannelShardedEngine(cfg, codes,
                               mesh=channel_mesh(devices=["cuda:0"] * 4))
    st, sst = eng.init_state(), sen.init_state()
    for ch, s in enumerate(sats):
        args = (ch, ch, s.delay_chips / 1.023e6 * FS, s.doppler_hz, 0, 0)
        st = eng.activate_channel(st, *args)
        sst = sen.activate_channel(sst, *args)
    span = len(x) - cfg.epoch_samples_max
    xd = torch.from_numpy(x).to("cuda:0")
    st1, o1 = eng.track_capture(xd, st, span)
    st2, o2 = sen.track_capture(xd, sst, span)
    assert o1.valid.sum() > 0.9 * 199 * N_CH
    _same(o2, o1)
    a, b = state_to_numpy(gather_channel_tree(st2)), state_to_numpy(st1)
    for k, v in b.items():
        for u, w in zip(a[k] if isinstance(v, tuple) else (a[k],),
                        v if isinstance(v, tuple) else (v,)):
            np.testing.assert_array_equal(u, w, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("correlator", ["chunked", "gather"])
def test_logical_gpu_shards_symbols_equal_unsharded(capture, correlator):
    from gnss_sdr_1_tpu_torch.ops import symbol_slots as ss

    sats, codes, x = capture
    cfg = TrackConfig(fs_hz=FS, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=N_CH, correlator=correlator)
    eng = TrackingEngine(cfg, codes, device="cuda:0")
    sen = ChannelShardedEngine(cfg, codes,
                               mesh=channel_mesh(devices=["cuda:0"] * 4))
    st, sst = eng.init_state(), sen.init_state()
    for ch, s in enumerate(sats):
        args = (ch, ch, s.delay_chips / 1.023e6 * FS, s.doppler_hz, 0, 0)
        st = eng.activate_channel(st, *args)
        sst = sen.activate_channel(sst, *args)
    span = len(x) - cfg.epoch_samples_max
    xd = torch.from_numpy(x).to("cuda:0")
    sym_off = np.arange(N_CH) * 3 % 20 + 1
    before = ss.launches
    _, s1 = eng.track_capture_symbols(xd, st, span, sym_off, 20)
    _, s2 = sen.track_capture_symbols(xd, sst, span, sym_off, 20)
    assert ss.launches == before + 1 + 4
    assert s1.n_valid.sum() > 0.9 * 199 * N_CH
    _same(s2, s1)


@pytest.mark.gpu
def test_sharded_acquisition_on_the_card_equals_unsharded(capture):
    _, _, x = capture
    cfg = AcqConfig(fs_hz=FS, samples_per_code=4092, samples_per_chip=4,
                    max_dwells=2)
    codes = {p: gps_l1ca_code(p) for p in range(1, 33)}
    want = PcpsAcquisition(cfg, codes, fs_code_rate=(1.023e6, 1023),
                           device="cuda:0").acquire(x)
    got = ChannelShardedAcquisition(
        cfg, codes, mesh=channel_mesh(devices=["cuda:0"] * 4),
        fs_code_rate=(1.023e6, 1023)).acquire(x)
    for name in ("positive", "delay_samples", "doppler_hz", "test_stat"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.positive[:N_CH].all()
