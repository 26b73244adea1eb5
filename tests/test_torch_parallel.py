"""The port's `parallel/` package on the CPU: meshes, channel-sharded trees,
the channel-sharded tracking engine (chunked and gather correlators) and
PCPS acquisition, the time-sharded conditioner with its halo exchange, and
two processes joined by torch.distributed (gloo).

Held to: the port's unsharded engine, acquisition and conditioner bit for
bit (a mesh of `["cpu"] * n` runs every shard through the same plain
versions); the JAX package's sharded runs on the 8 virtual CPU devices of
tests/conftest.py at ROADMAP.md's bars ("Engine, one capture": valid and
start exact, Doppler and code at 2e-2, the fields the JAX package ships as
f16 at f16 resolution; "Acquisition": the same detections and Doppler
bins, delay within 1 sample, statistics to rtol 1e-4); the time-sharded
FIR to np.convolve as tests/test_parallel.py holds the JAX one.  Also the
three public functions the port gained under the JAX package's names:
`freq_xlating_fir`, `names` and `multicorrelate_batch`."""

import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.parallel import channel_mesh as jchannel_mesh
from gnss_sdr_1_tpu.parallel import replicate as jreplicate
from gnss_sdr_1_tpu.parallel import shard_channel_tree as jshard
from gnss_sdr_1_tpu.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
from gnss_sdr_1_tpu.utils.planar import to_planar
from gnss_sdr_1_tpu_torch import parallel as tpar
from gnss_sdr_1_tpu_torch.acquire import AcqConfig, PcpsAcquisition
from gnss_sdr_1_tpu_torch.condition import Conditioner, freq_xlating_fir
from gnss_sdr_1_tpu_torch.parallel import (ChannelShardedAcquisition,
                                           ChannelShardedEngine,
                                           channel_mesh,
                                           freq_xlating_fir_time_sharded,
                                           gather_channel_tree,
                                           halo_exchange_blocks,
                                           host_channel_mesh,
                                           init_distributed, replicate,
                                           shard_channel_tree,
                                           shard_host_channel_tree,
                                           time_mesh)
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 1.023e6                 # one sample a chip: 1,023-sample epochs
N_CH = 8
PRNS = list(range(1, N_CH + 1))
F16_RTOL = 2.0 ** -10        # one f16 ulp, relative
KW = dict(fs_hz=FS, code_length_chips=1023, chip_rate_chips_s=1.023e6,
          carrier_freq_hz=1575.42e6, n_channels=N_CH, chunk_epochs=4)


@pytest.fixture(scope="module")
def capture():
    rng = np.random.default_rng(0)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=46.0)
            for p in PRNS]
    codes = np.stack([gps_l1ca_code(p) for p in PRNS])
    x = generate_baseband(GPS_L1_CA, sats, dict(zip(PRNS, codes)), FS, 0.04,
                          noise=True)
    return sats, codes, x


def _activation(sats, ch):
    s = sats[ch]
    return ch, s.delay_chips + 0.3, s.doppler_hz + 25.0, 0, 0


def _port(correlator, codes, sats, mesh=None):
    cfg = TrackConfig(correlator=correlator, **KW)
    eng = (TrackingEngine(cfg, codes, device="cpu") if mesh is None
           else ChannelShardedEngine(cfg, codes, mesh=mesh))
    st = eng.init_state()
    for ch in range(N_CH):
        st = eng.activate_channel(st, ch, *_activation(sats, ch))
    return eng, st


def _assert_outputs_equal(got, want):
    assert type(got) is type(want)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def _assert_states_equal(got, want):
    a, b = state_to_numpy(got), state_to_numpy(want)
    for k, v in b.items():
        for u, w in zip(a[k] if isinstance(v, tuple) else (a[k],),
                        v if isinstance(v, tuple) else (v,)):
            np.testing.assert_array_equal(u, w, err_msg=k)


# --------------------------------------------------------------- meshes --


def test_mesh_structure():
    mesh = channel_mesh(devices=["cpu"] * 8)
    assert mesh.axis_names == ("channel",) and mesh.shape == {"channel": 8}
    assert mesh.size == 8
    assert mesh.local_devices() == [torch.device("cpu")] * 8
    assert channel_mesh(3, devices=["cpu"] * 2).size == 2  # JAX: as given
    assert time_mesh(devices=["cpu"] * 4).shape == {"time": 4}
    host = host_channel_mesh(local_devices=["cpu", "cpu"])
    assert host.shape == {"host": 1, "channel": 2}
    assert host.process_index == 0 and len(host.local_devices()) == 2


def test_mesh_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal is for hosts without one")
    for make in (channel_mesh, time_mesh, host_channel_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        channel_mesh(devices=["cpu", "cuda"])
    cfg = TrackConfig(**KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChannelShardedEngine(cfg, np.ones((N_CH, 1023), np.float32))


def test_shard_and_gather_channel_tree():
    mesh = channel_mesh(devices=["cpu"] * 4)
    tree = {"per_channel": np.arange(24, dtype=np.float32).reshape(8, 3),
            "odd": torch.arange(5), "scalar": 7,
            "pair": (torch.arange(8), np.zeros(4, bool))}
    sh = shard_channel_tree(tree, mesh)
    assert len(sh) == 4
    for j, s in enumerate(sh):
        np.testing.assert_array_equal(s["per_channel"].numpy(),
                                      tree["per_channel"][2 * j:2 * j + 2])
        assert torch.equal(s["odd"], tree["odd"])          # replicated
        assert s["scalar"] == 7
        assert s["pair"][0].tolist() == [2 * j, 2 * j + 1]
        assert s["pair"][1].shape == (1,)
    back = gather_channel_tree(sh)
    np.testing.assert_array_equal(back["per_channel"].numpy(),
                                  tree["per_channel"])
    assert torch.equal(back["odd"], tree["odd"])
    assert back["pair"][0].tolist() == list(range(8))


def test_replicate_one_copy_a_device():
    x = torch.arange(10).to(torch.complex64)
    reps = replicate(x, channel_mesh(devices=["cpu"] * 3))
    assert len(reps) == 3 and all(r is reps[0] for r in reps)
    assert torch.equal(reps[0], x)


def test_init_distributed_unconfigured_and_refusals(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, process_id=0)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed()
    with pytest.raises(ValueError, match="rank"):
        init_distributed(coordinator="127.0.0.1:1")
    with pytest.raises(ValueError, match="outside"):
        init_distributed(coordinator="127.0.0.1:1", process_id=4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_rank(rank, port, out):
    """One rank of the two-process run: join, shard, gather every rank's
    blocks, report."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        assert init_distributed(f"127.0.0.1:{port}", 2, rank)
        mesh = host_channel_mesh(local_devices=["cpu", "cpu"])
        tree = {"ch": torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3),
                "odd": torch.arange(3)}
        sh = shard_host_channel_tree(tree, mesh)
        mine = torch.cat([s["ch"] for s in sh])
        parts = [torch.empty_like(mine) for _ in range(2)]
        dist.all_gather(parts, mine)
        out.put((rank, mesh.shape, mine.tolist(), torch.cat(parts).tolist(),
                 sh[0]["odd"].tolist()))
        dist.destroy_process_group()
    except Exception as err:            # reported to the test, then fails
        out.put((rank, "error", repr(err)))


def test_host_channel_mesh_two_processes_gloo():
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_host_rank, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            item = out.get(timeout=90)
            got[item[0]] = item
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(not p.is_alive() for p in procs)
    whole = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank in (0, 1):
        r = got[rank]
        assert r[1] != "error", r
        assert r[1] == {"host": 2, "channel": 2}
        # rank r holds blocks 2r and 2r + 1 of four: channels 4r .. 4r + 3
        np.testing.assert_array_equal(r[2], whole[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(r[3], whole)
        assert r[4] == [0, 1, 2]


# ------------------------------------------------ channel-sharded engine --


@pytest.mark.parametrize("correlator", ["chunked", "gather"])
def test_sharded_capture_equals_unsharded(capture, correlator):
    """Over 8 CPU shards of one channel each: every output field, and the
    final state, bit for bit the unsharded engine's."""
    sats, codes, x = capture
    eng, st = _port(correlator, codes, sats)
    span = len(x) - eng.cfg.epoch_samples_max
    st1, o1 = eng.track_capture(torch.from_numpy(x), st, span)
    mesh = channel_mesh(devices=["cpu"] * 8)
    sen = ChannelShardedEngine(eng.cfg, codes, mesh=mesh)
    st2, o2 = sen.track_capture(replicate(torch.from_numpy(x), mesh),
                                shard_channel_tree(st, mesh), span)
    assert o1.valid.sum() > 0.9 * 39 * N_CH
    _assert_outputs_equal(o2, o1)
    _assert_states_equal(gather_channel_tree(st2), st1)
    # the engine's own state, activated channel by global channel, is the
    # sharded unsharded state
    _, st_own = _port(correlator, codes, sats, mesh)
    _assert_states_equal(gather_channel_tree(st_own), st)


@pytest.mark.parametrize("correlator", ["chunked", "gather"])
def test_sharded_symbols_and_block_equal_unsharded(capture, correlator):
    sats, codes, x = capture
    eng, st = _port(correlator, codes, sats)
    mesh = channel_mesh(devices=["cpu"] * 4)
    sen, sst = _port(correlator, codes, sats, mesh)
    span = len(x) - eng.cfg.epoch_samples_max
    sym_off = np.array([20, 7, 13, 1, 20, 3, 11, 19], dtype=np.int32)
    xt = torch.from_numpy(x)
    st1, s1 = eng.track_capture_symbols(xt, st, span, sym_off, 20)
    st2, s2 = sen.track_capture_symbols(xt, sst, span, sym_off, 20)
    assert s1.n_valid.sum() > 0.9 * 39 * N_CH
    _assert_outputs_equal(s2, s1)
    _assert_states_equal(gather_channel_tree(st2), st1)
    base = 20000
    st1, b1 = eng.track_block(x[:base + eng.cfg.epoch_samples_max], st, base)
    st2, b2 = sen.track_block(x[:base + eng.cfg.epoch_samples_max], sst,
                              base)
    _assert_outputs_equal(b2, b1)
    _assert_states_equal(gather_channel_tree(st2), st1)


def _close_f16(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("correlator,jax_correlator",
                         [("chunked", "mxu"), ("gather", "gather")])
def test_sharded_capture_matches_jax_sharded(capture, correlator,
                                             jax_correlator):
    """The port's engine over 8 CPU shards against the JAX engine over the
    8 virtual devices (tests/test_parallel.py's call), at the bars of
    ROADMAP.md's 'Engine, one capture'."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    sats, codes, x = capture
    ej = JEngine(JTrackConfig(correlator=jax_correlator, **KW), codes)
    sj = ej.init_state()
    for ch in range(N_CH):
        sj = ej.activate_channel(sj, ch, *_activation(sats, ch))
    span = len(x) - ej.cfg.epoch_samples_max
    jm = jchannel_mesh(8)
    stj, oj = ej.track_capture(jreplicate(to_planar(x), jm),
                               jshard(sj, jm), span)
    mesh = channel_mesh(devices=["cpu"] * 8)
    sen, st = _port(correlator, codes, sats, mesh)
    st_t, ot = sen.track_capture(x, st, span)
    vj = np.asarray(oj.valid)
    np.testing.assert_array_equal(ot.valid, vj)
    assert vj.sum() > 0.9 * 39 * N_CH
    np.testing.assert_array_equal(ot.start[vj], np.asarray(oj.start)[vj])
    np.testing.assert_array_equal(ot.cur_len[vj], np.asarray(oj.cur_len)[vj])
    for name in ("carrier_doppler_hz", "rem_code_phase_samples"):
        np.testing.assert_allclose(getattr(ot, name)[vj],
                                   np.asarray(getattr(oj, name))[vj],
                                   rtol=0, atol=2e-2, err_msg=name)
    _close_f16(ot.code_freq_delta[vj], np.asarray(oj.code_freq_delta)[vj],
               2e-2, "delta")
    _close_f16(ot.cn0_dbhz[vj], np.asarray(oj.cn0_dbhz)[vj], 2e-2, "cn0")
    cj = np.asarray(oj.correlators)
    pj = cj[..., 1, 0] + 1j * cj[..., 1, 1]
    pt = ot.correlators[..., 1]
    _close_f16(pt.real[vj], pj.real[vj], 2e-2, "prompt I")
    _close_f16(pt.imag[vj], pj.imag[vj], 2e-2, "prompt Q")
    stn = state_to_numpy(gather_channel_tree(st_t))
    np.testing.assert_array_equal(stn["start"], np.asarray(stj.start))
    np.testing.assert_array_equal(stn["active"], np.asarray(stj.active))
    np.testing.assert_allclose(stn["carrier_doppler_hz"],
                               np.asarray(stj.carrier_doppler_hz), rtol=0,
                               atol=2e-2)


def _clamp_case(codes, sats, starts):
    """The gather engine with every channel activated at the truth, then
    its epoch starts set to `starts` (their spread beyond one code period
    makes the window origin's clamp bite)."""
    eng, st = _port("gather", codes, sats)
    st = st._replace(start=torch.as_tensor(starts, dtype=torch.int32))
    return eng, st


def _clamped_epochs(eng, out, st, n_samp):
    """Valid (epoch, channel) pairs whose start lies past the unsharded
    walk's window origin by more than its slack."""
    win = min(eng._win, n_samp)
    slack = win - eng.cfg.epoch_samples_max
    act = np.concatenate([st.active.numpy()[None], out.active[:-1]])
    lo = np.where(act, out.start, 1 << 29).min(axis=1)
    m = np.clip(lo, 0, n_samp - win)[:, None]
    return out.valid & (out.start - m > slack)


def test_gather_window_clamp_bites_in_one_shard(capture):
    """Channel 3 starts two code periods after channel 0: the clamp of the
    window origin bites for it in the unsharded walk and in shard 0, which
    holds both; shard 1's channels start within a period of channel 0, so
    no clamp bites for them in either.  The sharded run is the unsharded
    one, bit for bit."""
    sats, codes, x = capture
    starts = [10, 400, 700, 10 + 2 * 1023 + 80, 30, 600, 900, 200]
    eng, st = _clamp_case(codes, sats, starts)
    n_samp = len(x)
    span = n_samp - 3 * eng.cfg.epoch_samples_max
    st1, o1 = eng.track_capture(torch.from_numpy(x), st, span)
    clamped = _clamped_epochs(eng, o1, st, n_samp)
    assert clamped[:, 3].sum() > 10 and not clamped[:, 4:].any()
    mesh = channel_mesh(devices=["cpu"] * 2)
    sen = ChannelShardedEngine(eng.cfg, codes, mesh=mesh)
    st2, o2 = sen.track_capture(x, shard_channel_tree(st, mesh), span)
    _assert_outputs_equal(o2, o1)
    _assert_states_equal(gather_channel_tree(st2), st1)


def test_gather_split_that_moves_a_window_raises(capture):
    """Channel 5 starts two code periods after channel 0, in another
    shard: under the unsharded origin its window is clamped, under its own
    shard's it is not.  The sharded engine refuses the result."""
    sats, codes, x = capture
    starts = [10, 400, 700, 300, 2 * 1023 + 10, 2 * 1023 + 90, 2 * 1023,
              2 * 1023 + 40]
    eng, st = _clamp_case(codes, sats, starts)
    span = len(x) - 3 * eng.cfg.epoch_samples_max
    _, o1 = eng.track_capture(torch.from_numpy(x), st, span)
    assert _clamped_epochs(eng, o1, st, len(x))[:, 4:].any()
    mesh = channel_mesh(devices=["cpu"] * 2)
    sen = ChannelShardedEngine(eng.cfg, codes, mesh=mesh)
    with pytest.raises(RuntimeError, match="moves the gather walk's window"):
        sen.track_capture(x, shard_channel_tree(st, mesh), span)


def test_sharded_engine_refuses_bad_inputs(capture):
    sats, codes, x = capture
    mesh = channel_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="do not split"):
        ChannelShardedEngine(TrackConfig(**KW), codes, mesh=mesh)
    sen, st = _port("chunked", codes, sats, channel_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="ChannelShards"):
        sen.track_capture(x, gather_channel_tree(st), 1000)
    with pytest.raises(ValueError, match="sample tensors"):
        sen.track_capture([torch.from_numpy(x)], st, 1000)
    with pytest.raises(IndexError):
        sen.activate_channel(st, N_CH, 0, 0.0, 0.0, 0, 0)


# ----------------------------------------------------------- acquisition --


def test_sharded_acquisition_matches_unsharded_and_jax_sharded(capture):
    """16 PRNs' PCPS grid over 8 CPU shards: the unsharded AcqResult bit
    for bit, and JAX `_pcps_core` with its channel axis sharded over the 8
    virtual devices as `dryrun_multichip` shards it, at the acquisition
    bar."""
    from gnss_sdr_1_tpu.acquire.pcps import _pcps_core

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    _, _, x = capture
    prns = list(range(1, 17))
    cfg = AcqConfig(fs_hz=FS, samples_per_code=1023, samples_per_chip=1,
                    doppler_max_hz=5000.0, doppler_step_hz=500.0,
                    max_dwells=1, pfa=0.01)
    code_map = {p: gps_l1ca_code(p) for p in prns}
    one = PcpsAcquisition(cfg, code_map, device="cpu")
    sharded = ChannelShardedAcquisition(
        cfg, code_map, mesh=channel_mesh(devices=["cpu"] * 8))
    want = one.acquire(x)
    got = sharded.acquire(x)
    for name in ("positive", "delay_samples", "doppler_hz", "test_stat"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.positive[:N_CH].all() and not got.positive[N_CH:].any()
    assert sharded.threshold == one.threshold
    jm = jchannel_mesh(8)
    eff = cfg.effective_size
    cfc = jax.device_put(to_planar(one._code_fft_conj.numpy()),
                         NamedSharding(jm, P("channel", None, None)))
    grid0 = jax.device_put(
        jnp.zeros((len(prns), cfg.num_doppler_bins, eff), jnp.float32),
        NamedSharding(jm, P("channel", None, None)))
    _, stats = _pcps_core(
        jreplicate(to_planar(x[:cfg.fft_size]), jm), cfc,
        jreplicate(to_planar(one._wipeoffs.numpy()), jm), grid0, eff,
        cfg.samples_per_code, cfg.samples_per_chip)
    stat, _, delay, d_idx, _ = (np.asarray(s) for s in stats)
    np.testing.assert_array_equal(got.positive, stat > one.threshold)
    np.testing.assert_array_equal(got.doppler_hz,
                                  cfg.doppler_bins_hz()[d_idx])
    dd = np.abs(got.delay_samples - delay)
    assert (np.minimum(dd, 1023 - dd) <= 1.0).all()
    np.testing.assert_allclose(got.test_stat, stat, rtol=1e-4)


# ------------------------------------------------ time-sharded conditioner --


def test_halo_exchange_makes_time_sharded_fir_exact():
    """tests/test_parallel.py's overlap-save case on the port's blocks:
    each block's 'valid' convolution with its neighbour's halo equals the
    whole stream's."""
    n_dev, n_per = 8, 1024
    taps = np.hanning(17).astype(np.float32)
    taps /= taps.sum()
    halo = len(taps) - 1
    x = np.random.default_rng(1).standard_normal(n_dev * n_per).astype(
        np.float32)
    blocks = [torch.from_numpy(x[j * n_per:(j + 1) * n_per])
              for j in range(n_dev)]
    ext = halo_exchange_blocks(blocks, halo)
    assert [e.shape[0] for e in ext] == [n_per + halo] * n_dev
    np.testing.assert_array_equal(ext[-1][n_per:].numpy(), x[:halo])
    k = torch.from_numpy(taps[::-1].copy())
    y = np.concatenate([e.unfold(0, halo + 1, 1).matmul(k).numpy()
                        for e in ext])
    ref = np.convolve(x, taps, mode="full")[halo:halo + len(x)]
    np.testing.assert_allclose(y[:len(x) - halo], ref[:len(x) - halo],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_dev", [3, 4])
def test_time_sharded_conditioner_equals_one_device(n_dev):
    """An IF stream mixed, filtered and decimated over time blocks on
    `n_dev` CPU entries: the one-device conditioner's output bit for bit
    (the last entry's blocks short of a whole run, the tail flushed)."""
    from gnss_sdr_1_tpu_torch.condition import design_lowpass_fir

    rng = np.random.default_rng(2)
    n = 10 * 4096 + 1234
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    taps = design_lowpass_fir(33, 0.4e6, 4e6)
    args = (taps, 4e6, 420e3, 2)
    want = Conditioner(*args, block_size=4096, device="cpu").process(
        x, flush=True)
    got = freq_xlating_fir_time_sharded(
        x, *args, mesh=time_mesh(devices=["cpu"] * n_dev), block_size=4096)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # at the default block size the whole stream is one block: one entry
    np.testing.assert_array_equal(
        freq_xlating_fir_time_sharded(
            x, *args, mesh=time_mesh(devices=["cpu"] * n_dev)),
        freq_xlating_fir(x, *args, device="cpu"))


def test_conditioner_start_at_continues_the_stream():
    """start_at(history, k) then the rest of a stream gives the one
    stream's output after k blocks."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(5 * 512) + 1j * rng.standard_normal(5 * 512)
         ).astype(np.complex64)
    taps = np.hanning(9).astype(np.float32)
    whole = Conditioner(taps, 2e6, 300e3, 1, 512, device="cpu")
    want = whole.process(x, flush=True)
    rest = Conditioner(taps, 2e6, 300e3, 1, 512, device="cpu")
    rest.start_at(x[3 * 512 - 8:3 * 512], 3)
    np.testing.assert_array_equal(rest.process(x[3 * 512:], flush=True),
                                  want[3 * 512:])
    with pytest.raises(ValueError, match="history"):
        rest.start_at(x[:3], 1)


# -------------------------------- the JAX package's names, in the port --


def test_freq_xlating_fir_matches_jax():
    from gnss_sdr_1_tpu.condition.filters import freq_xlating_fir as jfir
    from gnss_sdr_1_tpu_torch.condition import design_lowpass_fir

    rng = np.random.default_rng(4)
    x = (rng.standard_normal(3 * 8192 + 77)
         + 1j * rng.standard_normal(3 * 8192 + 77)).astype(np.complex64)
    taps = design_lowpass_fir(31, 0.5e6, 4e6)
    want = np.asarray(jfir(x, taps, 4e6, 420e3, 2))
    got = freq_xlating_fir(x, taps, 4e6, 420e3, 2, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_names_match_jax():
    from gnss_sdr_1_tpu.runtime import factory as jfactory
    from gnss_sdr_1_tpu_torch.runtime import factory as tfactory

    kinds = {b.kind for b in jfactory._BLOCKS}
    assert len(kinds) > 3
    for kind in [None, *sorted(kinds)]:
        assert tfactory.names(kind) == jfactory.names(kind), kind
    assert tfactory.names("no such kind") == []


def test_multicorrelate_batch_matches_jax():
    from gnss_sdr_1_tpu.ops import multicorrelate_batch as jbatch
    from gnss_sdr_1_tpu_torch.ops import multicorrelate_batch

    rng = np.random.default_rng(5)
    C, N = 4, 4092
    samples = (rng.standard_normal((C, N))
               + 1j * rng.standard_normal((C, N))).astype(np.complex64)
    code = np.stack([gps_l1ca_code(p) for p in range(1, C + 1)])
    shifts = np.array([-0.5, 0.0, 0.5], np.float32)
    args = [rng.uniform(0.24, 0.26, C), rng.uniform(0, 1023, C),
            rng.uniform(-3, 3, C), rng.uniform(-0.01, 0.01, C),
            np.zeros(C), np.full(C, N - 7)]
    args = [a.astype(np.float32) for a in args]
    want = np.asarray(jbatch(jnp.asarray(samples), jnp.asarray(code),
                             jnp.asarray(shifts),
                             *(jnp.asarray(a) for a in args)))
    got = multicorrelate_batch(
        torch.from_numpy(samples), torch.from_numpy(code),
        torch.from_numpy(shifts), *(torch.from_numpy(a) for a in args))
    assert got.shape == (C, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_parallel_exports_the_jax_names():
    from gnss_sdr_1_tpu import parallel as jpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)), name
