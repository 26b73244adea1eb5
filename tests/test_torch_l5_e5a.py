"""The port's GPS L5 and Galileo E5a paths against the JAX package's, on
the CPU.

- The L5 I/Q codes, NH10/NH20, the E5a I/Q memory codes, CS20 and CS100,
  the signal constants and `tracking_replica('L5' | '5X')`, element for
  element.
- The L5 (CNAV) and E5a (F/NAV) scenarios and the generator, bit for bit.
- `GpsL5ChannelDecoder` and `GalileoE5aChannelDecoder` fed the same soft
  prompts from a scenario's stream: the same secondary sync, symbols, TOW
  and ephemeris.
- The receivers' acquisition: PCPS on L5 and the CAF on E5a, the same
  detections, Doppler bins, delays within 1 sample, statistics at rtol
  1e-4.
- The chunked engine with the secondary wipe on:
  tests/test_torch_l5_e5a_engine.py.
- A short receiver run per signal that reaches the extended,
  secondary-wiped mode: the same assignments, symbol counts and
  `sec_sync_offset` as the JAX receiver.
"""

import dataclasses

import numpy as np
import pytest

import gnss_sdr_1_tpu.codes as jcodes
import gnss_sdr_1_tpu.constants as jconst
import gnss_sdr_1_tpu.siggen.scenario as jscen
import gnss_sdr_1_tpu.telemetry.channel_adapters as jadapt
from gnss_sdr_1_tpu.codes.galileo_e5 import galileo_e5aq_secondary as j_cs100
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
from gnss_sdr_1_tpu.runtime import ReceiverConfig as JReceiverConfig
from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
import gnss_sdr_1_tpu_torch.codes as tcodes
import gnss_sdr_1_tpu_torch.constants as tconst
import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
import gnss_sdr_1_tpu_torch.telemetry.channel_adapters as tadapt
from gnss_sdr_1_tpu_torch.codes.galileo_e5 import \
    galileo_e5aq_secondary as t_cs100
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.siggen.generator import generate_baseband as tgen
from gnss_sdr_1_tpu_torch.track.engine import state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 12.0e6              # 1.17 samples per chip, as the system test
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
SIGNALS = {"L5": ("GPS_L5", 10), "5X": ("GALILEO_E5A", 20)}
F16_RTOL = 2.0 ** -10        # one f16 ulp, relative


def _sec(signal, mod):
    """The signal's data-channel secondary code in `mod`'s codes."""
    if signal == "L5":
        return np.asarray(mod.NH10, np.float32)
    from importlib import import_module

    e5 = import_module(mod.__name__ + ".galileo_e5")
    return np.asarray(e5.galileo_e5ai_secondary(), np.float32)


def _spec(mod, signal):
    """Generation spec: the secondary-modulated symbols as a 1 kbps stream
    (tests/test_system_l5.py)."""
    return dataclasses.replace(getattr(mod, SIGNALS[signal][0]),
                               bit_rate_bps=1000.0)


# ---------------------------------------------------------------------------
# codes and constants
# ---------------------------------------------------------------------------


def test_l5_e5a_constants_and_secondary_codes_identical():
    for name in ("FREQ_L5", "FREQ_E5A"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for sid in SIGNALS:
        assert dataclasses.asdict(tconst.SIGNALS[sid]) == \
            dataclasses.asdict(jconst.SIGNALS[sid])
    for name in ("NH10", "NH20"):
        a, b = getattr(jcodes, name), getattr(tcodes, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_sec("5X", tcodes), _sec("5X", jcodes))
    assert _sec("L5", tcodes).shape == (10,)
    assert _sec("5X", tcodes).shape == (20,)


@pytest.mark.parametrize("prn", range(1, 33))
def test_l5_codes_and_replica_identical(prn):
    for gen in ("gps_l5i_code", "gps_l5q_code"):
        a, b = getattr(jcodes, gen)(prn), getattr(tcodes, gen)(prn)
        assert a.dtype == b.dtype and a.shape == b.shape == (10230,)
        np.testing.assert_array_equal(a, b, err_msg=gen)
    ra, rb = jcodes.tracking_replica("L5", prn), tcodes.tracking_replica(
        "L5", prn)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:] == (10.23e6, 1)


@pytest.mark.parametrize("prn", range(1, 51))
def test_e5a_codes_and_replica_identical(prn):
    for gen in ("galileo_e5ai_code", "galileo_e5aq_code"):
        a, b = getattr(jcodes, gen)(prn), getattr(tcodes, gen)(prn)
        assert a.dtype == b.dtype and a.shape == b.shape == (10230,)
        np.testing.assert_array_equal(a, b, err_msg=gen)
    if prn <= 47:                 # the ICD lists 47 CS100 pilot codes
        np.testing.assert_array_equal(t_cs100(prn), j_cs100(prn))
    ra, rb = jcodes.tracking_replica("5X", prn), tcodes.tracking_replica(
        "5X", prn)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:] == (10.23e6, 1)


# ---------------------------------------------------------------------------
# scenario and generator
# ---------------------------------------------------------------------------


def _scenarios(signal, prns, duration):
    kw = dict(t0_tow=345601.25, duration_s=duration, cn0_dbhz=48.0,
              chip_rate=10.23e6, signal=signal)
    return (jscen.build_scenario(RX, list(prns), **kw),
            tscen.build_scenario(RX, list(prns), **kw))


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_scenario_and_generator_identical(signal):
    sj, st = _scenarios(signal, (3, 11, 24), 12.0)
    assert sj.bits_tow0 == st.bits_tow0
    for p in (3, 11, 24):
        assert dataclasses.asdict(sj.ephemerides[p]) == \
            dataclasses.asdict(st.ephemerides[p])
    for a, b in zip(sj.sats, st.sats):
        assert (a.prn, a.doppler_hz, a.delay_chips, a.doppler_rate_hz_s,
                a.bit_rate_override_bps) == (
            b.prn, b.doppler_hz, b.delay_chips, b.doppler_rate_hz_s,
            b.bit_rate_override_bps) and b.bit_rate_override_bps == 1000.0
        np.testing.assert_array_equal(a.nav_bits, b.nav_bits)
    codes = {s.prn: jcodes.tracking_replica(signal, s.prn)[0]
             for s in sj.sats}
    np.testing.assert_array_equal(
        tgen(_spec(tconst, signal), st.sats, codes, FS, 0.005, noise=True),
        jgen(_spec(jconst, signal), sj.sats, codes, FS, 0.005, noise=True))


# ---------------------------------------------------------------------------
# channel decoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signal,adapter,duration,skip", [
    ("L5", "GpsL5ChannelDecoder", 26.0, 1287),
    ("5X", "GalileoE5aChannelDecoder", 52.0, 2613)])
def test_channel_decoder_identical(signal, adapter, duration, skip):
    """Both decoders fed the same soft 1 ms prompts (a scenario's
    secondary-modulated stream with noise, starting mid-symbol) agree on
    secondary sync, the decoded symbols, TOW and the ephemeris."""
    sj, _ = _scenarios(signal, (7,), duration)
    bits = np.asarray(sj.sats[0].nav_bits)
    rng = np.random.default_rng(3)
    prompts = (bits * 80.0 + rng.normal(size=len(bits)) * 20.0)[skip:]
    prompts = prompts[: int(duration * 1000) - skip]
    dj, dt = getattr(jadapt, adapter)(7), getattr(tadapt, adapter)(7)
    for k in range(0, len(prompts), 997):
        dj.push(prompts[k:k + 997])
        dt.push(prompts[k:k + 997])
    n_sec = SIGNALS[signal][1]
    assert dt.sec_sync_offset == dj.sec_sync_offset == (-skip) % n_sec
    assert dj.ephemeris_complete and dt.ephemeris_complete
    np.testing.assert_array_equal(np.asarray(dt.raw._soft),
                                  np.asarray(dj.raw._soft))
    for s in (0, 5000, len(prompts) - 1):
        assert dt.tow_at_symbol(s) == dj.tow_at_symbol(s) is not None
    assert dataclasses.asdict(dt.raw.ephemeris) == \
        dataclasses.asdict(dj.raw.ephemeris)
    assert dataclasses.asdict(dt.ephemeris) == \
        dataclasses.asdict(dj.ephemeris)
    assert dt.ephemeris.sqrt_a == pytest.approx(sj.ephemerides[7].sqrt_a,
                                                abs=1e-3)
    if signal == "5X":
        assert dt.raw.pages == dj.raw.pages >= {1, 2, 3, 4}


# ---------------------------------------------------------------------------
# acquisition: PCPS on L5, the CAF on E5a
# ---------------------------------------------------------------------------


# the CAF statistic is the peak over F^2 times the input power (~1e-3 at
# 48 dB-Hz, ~4e-4 on noise at this shape): its threshold is on that scale
CAF_THRESHOLD = 5e-4


def _capture(signal, prns, duration, seed=1234):
    sj, _ = _scenarios(signal, prns, duration)
    codes = {p: jcodes.tracking_replica(signal, p)[0] for p in prns}
    return sj, jgen(_spec(jconst, signal), sj.sats, codes, FS, duration,
                    noise=True, seed=seed)


@pytest.fixture(scope="module")
def captures():
    # three 200 ms receiver segments and the last epoch's samples
    return {"L5": _capture("L5", (1, 3, 5), 0.602),
            "5X": _capture("5X", (11, 12, 13), 0.602)}


def _cfg_kw(signal, prns, **kw):
    """tests/test_system_l5.py's receiver configuration."""
    return {**dict(fs_hz=FS, signal_id=signal, n_channels=len(prns),
                   prn_search=tuple(prns), acq_dwells=2, pll_bw_hz=18.0,
                   dll_bw_hz=2.0, doppler_step2_hz=15.0,
                   num_doppler_bins_step2=40, iono_model="off"), **kw}


@pytest.mark.parametrize("signal,strategy", [("L5", "pcps"), ("5X", "caf")])
def test_acquisition_matches_jax(captures, signal, strategy):
    """The receivers' acquisition on the capture's head, searched over its
    satellites and one absent PRN: the same detections, Doppler bins,
    delays within 1 sample and statistics at rtol 1e-4."""
    scen, x = captures[signal]
    prns = tuple(s.prn for s in scen.sats) + (30,)
    kw = _cfg_kw(signal, prns, acq_strategy=strategy,
                 acq_threshold=CAF_THRESHOLD if strategy == "caf" else 2.0)
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    assert rt.acq_strategy == rj.acq_strategy == strategy
    assert type(rt.acq).__name__ == type(rj.acq).__name__
    head = x[: rt.acq.cfg.fft_size * 2]
    a, b = rt.acq.acquire(head), rj.acq.acquire(head)
    np.testing.assert_array_equal(a.positive, b.positive)
    # the satellites, not the absent PRN (the CAF adds the pilot's lag
    # grid, which holds only noise here: the generator makes the data
    # component alone, so one look at 48 dB-Hz can miss a satellite)
    assert a.positive[:3].sum() >= (3 if strategy == "pcps" else 2)
    assert not a.positive[3]
    np.testing.assert_array_equal(np.ravel(a.doppler_hz),
                                  np.ravel(b.doppler_hz))
    spc = rt.samples_per_code
    dd = np.abs(np.ravel(a.delay_samples) - np.ravel(b.delay_samples)) % spc
    assert (np.minimum(dd, spc - dd) <= 1.0).all()
    np.testing.assert_allclose(a.test_stat, b.test_stat, rtol=1e-4)


# ---------------------------------------------------------------------------
# the receiver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signal,strategy", [("L5", "pcps"), ("5X", "caf")])
def test_receiver_reaches_secondary_wipe_like_jax(captures, signal,
                                                  strategy):
    """0.6 s in 200 ms segments: acquisition, pull-in, secondary sync,
    then the extended mode with the in-loop wipe for the channels whose
    decoder synced; the same assignments, symbol counts, secondary sync,
    modes and secondary indices as the JAX receiver.  Acquisition over a
    1 ms coherent window leaves the Doppler 50-80 Hz off (PCPS's second
    step) or up to ~200 Hz off (the CAF, which has no second step), so the
    receivers pull in with a 45 Hz PLL to sync within the 0.6 s."""
    scen, x = captures[signal]
    prns = tuple(s.prn for s in scen.sats)
    kw = _cfg_kw(signal, prns, acq_strategy=strategy,
                 acq_threshold=CAF_THRESHOLD if strategy == "caf" else 2.0,
                 reacq_interval_blocks=5, pll_bw_hz=45.0)
    rj = JReceiver(JReceiverConfig(correlator="mxu", **kw))
    rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    rt.process(x)
    n_sec = SIGNALS[signal][1]
    assert rt._sec_period == rj._sec_period == n_sec
    assert rt.trk.cfg.extend_correlation_symbols == n_sec
    assert rt.trk.chain_spec.sec_len == n_sec
    assert rt.channel_prn == rj.channel_prn
    assert None not in rt.channel_prn
    assert set(rt._acq_info) == set(rj._acq_info)
    for prn, (dj, fj, sj) in rj._acq_info.items():
        dt, ft, st = rt._acq_info[prn]
        assert ft == fj, prn
        assert abs(dt - dj) <= 1.0, prn
    assert rt.sym_count == rj.sym_count
    offs = {p: d.sec_sync_offset for p, d in rt.decoders.items()}
    assert offs == {p: d.sec_sync_offset for p, d in rj.decoders.items()}
    assert list(rt._mode_host) == list(rj._mode_host)
    # the channels whose decoder synced went over to the wiped mode
    synced = [ch for ch, p in enumerate(rt.channel_prn)
              if offs[p] is not None]
    assert synced
    st = state_to_numpy(rt.state)
    np.testing.assert_array_equal(st["sec_on"], np.asarray(rj.state.sec_on))
    np.testing.assert_array_equal(st["sec_idx"],
                                  np.asarray(rj.state.sec_idx))
    assert st["sec_on"][synced].all() and (st["mode"][synced] == 1).all()
    assert rt._symbol_offsets() is None
