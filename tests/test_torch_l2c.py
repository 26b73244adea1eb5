"""GPS L2C (L2CM, '2S') in the port against the JAX package, on the CPU
(numpy inputs made from seeds; the JAX engine with `correlator='mxu'`).

- The L2CM codes of every PRN the ICD table holds and the tracking
  replica: bit for bit; the constants and the 2S scenario stream.
- Acquisition at tests/test_system_mixed.py's dual-band settings (50 Hz
  grid, 4 Hz fine step over 50 bins, threshold 1.6, the two-period window
  a 20 ms symbol forces): the same detections, the same Doppler bin,
  delays within 1 sample, statistics to rtol 1e-4.
- The chunk correlator at the L2CM shapes: a 20 ms epoch is ~41,000
  samples at 2.046 Msps and ~60,000 at gps_l2c_ibyte.conf's 3 Msps, which
  the kernel walks in 3 and 4 shared-memory tiles; the geometry, and the
  tile walk in plain torch ops against one pass (atol 1e-4 of max|z|).
- One engine capture at 2.046 Msps (three 16-epoch chunks of 320 ms) at
  the engine bars of ROADMAP.md (valid, start and cur_len exact; Doppler,
  code delta and rem code at atol 2e-2).
- The CNAV channel decoder on one noisy symbol stream: the same
  ephemeris and TOW.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnss_sdr_1_tpu.codes as jcodes
import gnss_sdr_1_tpu.constants as jconst
import gnss_sdr_1_tpu.siggen.scenario as jscen
import gnss_sdr_1_tpu_torch.codes as tcodes
import gnss_sdr_1_tpu_torch.constants as tconst
import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
from gnss_sdr_1_tpu.siggen import SatParams
from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
from gnss_sdr_1_tpu.utils.planar import to_planar
from gnss_sdr_1_tpu_torch.ops import chunk_corr as cc
from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy, state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
FS = 2.046e6
PRNS = (1, 2, 3, 4)
F16_RTOL = 2.0 ** -10
N_L2CM = 115        # PRNs of the ICD's L2CM initial-state table


@pytest.mark.parametrize("prn", range(1, N_L2CM + 1))
def test_l2cm_codes_bit_identical(prn):
    a, b = jcodes.gps_l2cm_code(prn), tcodes.gps_l2cm_code(prn)
    assert a.dtype == b.dtype and len(b) == 10230
    np.testing.assert_array_equal(a, b)


def test_l2c_replica_constants_and_scenario_identical():
    for prn in (1, 17, 63):
        rj, rt = (jcodes.tracking_replica("2S", prn),
                  tcodes.tracking_replica("2S", prn))
        np.testing.assert_array_equal(rt[0], rj[0])
        assert rt[1:] == rj[1:] == (0.5115e6, 1)
    with pytest.raises(ValueError):
        tcodes.gps_l2cm_code(N_L2CM + 1)
    assert dataclasses.asdict(tconst.SIGNALS["2S"]) == \
        dataclasses.asdict(jconst.SIGNALS["2S"])
    assert tconst.FREQ_L2 == jconst.FREQ_L2
    kw = dict(t0_tow=345601.25, duration_s=20.0, cn0_dbhz=47.0, signal="2S")
    sj = jscen.build_scenario(RX, list(PRNS), **kw)
    st = tscen.build_scenario(RX, list(PRNS), **kw)
    assert sj.bits_tow0 == st.bits_tow0 == 345600.0   # a 12 s CNAV boundary
    for a, b in zip(sj.sats, st.sats):
        assert (a.doppler_hz, a.delay_chips, a.bit_rate_override_bps) == (
            b.doppler_hz, b.delay_chips, b.bit_rate_override_bps)
        np.testing.assert_array_equal(a.nav_bits, b.nav_bits)


# ---------------------------------------------------------------------------
# acquisition
# ---------------------------------------------------------------------------


def _dual_band_cfg(mod):
    """The L2C group of tests/test_system_mixed.py's dual-band case."""
    from gnss_sdr_1_tpu.runtime.receiver import ReceiverConfig as JCfg

    return (JCfg if mod == "jax" else ReceiverConfig)(
        fs_hz=FS, signal_id="2S", n_channels=4, prn_search=PRNS,
        pll_bw_hz=4.0, dll_bw_hz=0.4, doppler_max_hz=3000.0,
        doppler_step_hz=50.0, acq_threshold=1.6, doppler_step2_hz=4.0,
        num_doppler_bins_step2=50, carrier_smoothing_epochs=200)


def test_acquisition_at_dual_band_settings_matches_jax():
    from gnss_sdr_1_tpu.runtime.receiver import Receiver as JReceiver

    scen = jscen.build_scenario(RX, list(PRNS), t0_tow=345601.25,
                                duration_s=0.1, cn0_dbhz=47.0, signal="2S")
    codes = {p: jcodes.tracking_replica("2S", p)[0] for p in PRNS}
    x = jgen(jconst.GPS_L2C, scen.sats, codes, FS, 0.1, noise=True, seed=4)
    aj = JReceiver(_dual_band_cfg("jax")).acq
    at = Receiver(_dual_band_cfg("port"), device="cpu").acq
    # a 20 ms CNAV symbol per code period: the two-period window
    assert at.cfg.bit_transition_flag and at.cfg.fft_size == 2 * 40920
    head = x[: at.cfg.fft_size * 2]
    rj, rt = aj.acquire(head), at.acquire(head)
    np.testing.assert_array_equal(rt.positive, rj.positive)
    assert rt.positive.sum() >= 3
    np.testing.assert_array_equal(rt.doppler_hz, rj.doppler_hz)
    spc = at.cfg.samples_per_code
    dd = np.abs(rt.delay_samples - rj.delay_samples) % spc
    assert (np.minimum(dd, spc - dd) <= 1.0).all()
    np.testing.assert_allclose(rt.test_stat, rj.test_stat, rtol=1e-4)
    for k, p in enumerate(at.prns):
        if rt.positive[k]:
            assert abs(rt.doppler_hz[k] - scen.truth[p]["doppler_hz"]) < 8.0


# ---------------------------------------------------------------------------
# the correlator's long windows and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs,tiles", [(2.046e6, 3), (3.0e6, 4)])
def test_l2c_window_geometry(fs, tiles):
    """The L2CM window is walked in several tiles whose replica stretches
    start 16-byte aligned and whose lag sums carry across tiles; every
    shared-memory index stays in range."""
    rx = Receiver(dataclasses.replace(_dual_band_cfg("port"), fs_hz=fs,
                                      n_channels=6), device="cpu")
    spec = rx.trk.corr_spec
    p = cc.corr_params(spec)
    NG = -(-spec.LW // p.tl)
    SL = p.S * p.L
    assert spec.NW > 40000 and p.tiles == tiles
    assert p.threads == NG * p.S <= cc.THREADS
    assert p.L % (4 * p.tl) == 0 and SL % 4 == 0
    assert (p.tiles - 1) * SL < spec.NW <= p.tiles * SL
    assert 2 * p.S * NG * p.tl <= p.wbuf and 2 * SL <= p.wbuf
    assert p.padl + SL + spec.LW - 1 <= p.qs and p.qs % 4 == 0
    assert p.smem_bytes == 4 * (p.wbuf + p.qs) <= cc.MAX_SMEM
    assert rx.trk.chain_spec.K == 3 and rx._sec_period is None


def _l2c_capture(duration_s=0.8):
    rng = np.random.default_rng(31)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-2500, 2500)),
                      delay_chips=float(rng.uniform(0, 10230)),
                      cn0_dbhz=47.0, nav_bits=rng.choice([-1.0, 1.0], 60),
                      bit_rate_override_bps=50.0)
            for p in PRNS[:3]]
    codes = np.stack([jcodes.tracking_replica("2S", s.prn)[0] for s in sats])
    x = jgen(jconst.GPS_L2C, sats, {s.prn: codes[k]
                                    for k, s in enumerate(sats)}, FS,
             duration_s, noise=True, seed=9)
    return sats, codes, x


_KW = dict(fs_hz=FS, code_length_chips=10230, chip_rate_chips_s=0.5115e6,
           carrier_freq_hz=jconst.FREQ_L2, n_channels=3, pll_bw_hz=4.0,
           dll_bw_hz=0.4)


@pytest.fixture(scope="module")
def l2c():
    sats, codes, x = _l2c_capture()
    et = TrackingEngine(TrackConfig(**_KW), codes, device="cpu")
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / 0.5115e6 * FS,
                                 s.doppler_hz, 0, 0)
    return sats, codes, x, et, st


def test_tile_walk_matches_one_pass_at_l2c(l2c):
    """The kernel's own tile walk (3 tiles of the 41k-sample window) in
    plain torch ops against the one-pass plain correlator on the first
    chunk of three activated L2CM channels."""
    sats, codes, x, et, st = l2c
    fst, ist = et._pack_rows(st, 10 ** 6)
    slot = st.prn_slot.to(torch.int32)
    seg = et._pad_for_chunks(torch.from_numpy(x))
    spec = et.corr_spec
    p = cc.corr_params(spec)
    assert p.tiles == 3
    got = cc.correlate_tiles_plain(spec, seg, et._rows, slot, fst, ist, p)
    want = cc.chunk_corr_plain(spec, seg, et._rows, slot, fst, ist)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())
    scale = float(max(want[0].abs().max(), want[1].abs().max()))
    assert scale > 1000.0          # the 20 ms correlation peak
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * scale)


def _leaves(st):
    return {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in st._asdict().items()}


def _state_from_jax(leaves):
    from gnss_sdr_1_tpu.track.engine import TrackState
    from gnss_sdr_1_tpu.track.loop_filter import FllPllState, IirState

    d = dict(leaves)
    d["carr_filter"] = FllPllState(*(jnp.asarray(a)
                                     for a in d["carr_filter"]))
    d["code_filter"] = IirState(*(jnp.asarray(a) for a in d["code_filter"]))
    return TrackState(**{k: (v if k in ("carr_filter", "code_filter")
                             else jnp.asarray(v)) for k, v in d.items()})


def test_engine_at_l2c_matches_jax(l2c):
    """Three L2CM channels activated at the truth and tracked 0.7 s (35
    epochs of 20 ms: three chunks, the last partial) by both engines from
    the same state.  The chunk spans 320 ms (~655,000 samples), and the
    epoch starts stay int32 and relative to the segment."""
    sats, codes, x, et, st = l2c
    ej = JEngine(JTrackConfig(correlator="mxu", **_KW), codes)
    leaves = state_to_numpy(st)
    span = int(FS * 0.7)
    st_j, oj = ej.track_capture(jnp.asarray(to_planar(x)),
                                _state_from_jax(leaves), span)
    st_t, ot = et.track_capture(torch.from_numpy(x),
                                state_from_numpy(leaves, "cpu"), span)
    assert et.capture_decim == 4
    np.testing.assert_array_equal(ot.valid, oj.valid)
    v = oj.valid
    assert v.sum() >= 3 * 34
    np.testing.assert_array_equal(ot.start[v], oj.start[v])
    np.testing.assert_array_equal(ot.cur_len[v], oj.cur_len[v])
    assert ot.start.dtype == np.int32 and ot.start[v].max() < span
    np.testing.assert_array_equal(ot.active, oj.active)
    assert ot.active[-1].all()
    for name in ("carrier_doppler_hz", "rem_code_phase_samples"):
        np.testing.assert_allclose(getattr(ot, name)[v],
                                   getattr(oj, name)[v], rtol=0, atol=2e-2,
                                   err_msg=name)
    np.testing.assert_allclose(ot.code_freq_delta[v], oj.code_freq_delta[v],
                               rtol=F16_RTOL, atol=2e-2)
    sj, stn = _leaves(st_j), state_to_numpy(st_t)
    for name in ("start", "cur_len", "push_count", "active"):
        np.testing.assert_array_equal(stn[name], sj[name], err_msg=name)
    for name in ("carrier_doppler_hz", "code_freq_delta",
                 "rem_code_phase_samples"):
        np.testing.assert_allclose(stn[name], sj[name], rtol=0, atol=2e-2,
                                   err_msg=name)
    for ch, s in enumerate(sats):
        assert abs(stn["carrier_doppler_hz"][ch] - s.doppler_hz) < 2.0


# ---------------------------------------------------------------------------
# the CNAV channel decoder
# ---------------------------------------------------------------------------


def test_l2_channel_decoder_identical():
    """Both L2CM channel decoders fed the same noisy soft symbols of a
    scenario's CNAV stream (one symbol per 20 ms epoch, types 10, 11, 30
    cycling) agree on the ephemeris, its Keplerian conversion and the TOW
    of every symbol."""
    import gnss_sdr_1_tpu.telemetry.channel_adapters as jadapt
    import gnss_sdr_1_tpu_torch.telemetry.channel_adapters as tadapt

    scen = jscen.build_scenario(RX, [3], t0_tow=345601.25, duration_s=50.0,
                                signal="2S")
    syms = np.asarray(scen.sats[0].nav_bits)
    rng = np.random.default_rng(6)
    prompts = (syms * 40.0 + rng.normal(size=len(syms)) * 12.0)[63:]
    dj, dt = jadapt.GpsL2ChannelDecoder(3), tadapt.GpsL2ChannelDecoder(3)
    for k in range(0, len(prompts), 97):
        dj.push(prompts[k:k + 97])
        dt.push(prompts[k:k + 97])
    assert dj.ephemeris_complete and dt.ephemeris_complete
    assert dataclasses.asdict(dt.raw.ephemeris) == \
        dataclasses.asdict(dj.raw.ephemeris)
    assert dataclasses.asdict(dt.ephemeris) == dataclasses.asdict(
        dj.ephemeris)
    for s in (0, 500, len(prompts) - 1):
        assert dt.tow_at_symbol(s) == dj.tow_at_symbol(s)
    assert dt.ephemeris.sqrt_a == pytest.approx(scen.ephemerides[3].sqrt_a,
                                                abs=1e-3)
