"""The port's chunked engine at the GPS L5 and Galileo E5a shapes with the
secondary-code wipe on, against the JAX package's engine with
`correlator='mxu'`, on the CPU (the rest of the L5/E5a slice:
tests/test_torch_l5_e5a.py).

Three channels at 12 Msps (1.17 samples per chip) are activated at the
truth and tracked 29 ms, switched to the extended mode with the wipe at
their true, non-zero secondary-code index by both engines, then tracked
0.2 s by both from the same state: the engine bars of ROADMAP.md (valid,
start and cur_len exact; Doppler, code delta and rem code at atol 2e-2),
over chunks whose seams the secondary index crosses.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnss_sdr_1_tpu.codes as jcodes
import gnss_sdr_1_tpu.constants as jconst
from gnss_sdr_1_tpu.siggen import SatParams
from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
from gnss_sdr_1_tpu.utils.planar import to_planar
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy, state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 12.0e6              # 1.17 samples per chip, as the system test
SIGNALS = {"L5": ("GPS_L5", 10), "5X": ("GALILEO_E5A", 20)}
F16_RTOL = 2.0 ** -10        # one f16 ulp, relative


def _sec(signal):
    """The signal's data-channel secondary code (the JAX package's)."""
    if signal == "L5":
        return np.asarray(jcodes.NH10, np.float32)
    from gnss_sdr_1_tpu.codes.galileo_e5 import galileo_e5ai_secondary

    return np.asarray(galileo_e5ai_secondary(), np.float32)


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


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_engine_with_secondary_wipe_matches_jax(signal):
    """Three channels activated at the truth and tracked 29 ms, switched
    to the extended mode with the secondary wipe at each channel's true
    (non-zero) code index by both engines, then 0.2 s by both: 16
    epochs per chunk against a 10- or 20-chip code, so the secondary index
    wraps inside chunks and the extension windows straddle chunk seams."""
    engine_secondary_wipe_parity(signal, FS, _sec(signal))


def engine_secondary_wipe_parity(signal, fs, sec, early_late=0.5):
    """The check of test_engine_with_secondary_wipe_matches_jax for
    `signal` at `fs` with the data-channel secondary code `sec` (also
    BeiDou's NH20 in tests/test_torch_beidou.py)."""
    n_sec = len(sec)
    spec = jconst.SIGNALS[signal]
    rate, n_chips = spec.code_rate_chips_s, spec.code_length_chips
    rng = np.random.default_rng(21)
    prns = (2, 9, 17)
    n_sym = 300 // n_sec
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, n_chips)),
                      cn0_dbhz=50.0,
                      nav_bits=(np.repeat(rng.choice([-1.0, 1.0], n_sym),
                                          n_sec) * np.tile(sec, n_sym)),
                      bit_rate_override_bps=1000.0)
            for p in prns]
    codes = np.stack([jcodes.tracking_replica(signal, p)[0] for p in prns])
    # the secondary-modulated symbols as a 1 kbps stream
    gen_spec = dataclasses.replace(spec, bit_rate_bps=1000.0)
    x = jgen(gen_spec, sats, {p: codes[k] for k, p in enumerate(prns)}, fs,
             0.26, noise=True, seed=5)
    kw = dict(fs_hz=fs, code_length_chips=n_chips, chip_rate_chips_s=rate,
              carrier_freq_hz=spec.carrier_freq_hz, n_channels=3,
              pll_bw_hz=18.0, dll_bw_hz=2.0, extend_correlation_symbols=n_sec,
              early_late_space_chips=early_late, sec_data=True)
    sec_codes = np.tile(sec, (3, 1))
    ej = JEngine(JTrackConfig(correlator="mxu", **kw), codes,
                 sec_codes=sec_codes)
    et = TrackingEngine(TrackConfig(**kw), codes, sec_codes=sec_codes,
                        device="cpu")
    assert et.chain_spec.sec_len == n_sec and et.chain_spec.sec_data
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / rate * fs,
                                 s.doppler_hz, 0, 0)
    head = int(fs * 0.029)
    st, _ = et.track_capture(torch.from_numpy(x), st, head)
    # epoch k of a channel carries secondary chip k mod n_sec
    phases = st.epochs_in_track.numpy() % n_sec
    assert (phases != 0).all(), phases
    # both engines switch the same state to the extended, wiped mode
    st_j = _state_from_jax(state_to_numpy(st))
    for ch in range(3):
        e = (n_sec - phases[ch]) % n_sec
        st = et.enable_extended(st, ch, e, sec_phase=int(phases[ch]))
        st_j = ej.enable_extended(st_j, ch, e, sec_phase=int(phases[ch]))
    leaves, lj = state_to_numpy(st), _leaves(st_j)
    assert set(leaves) == set(lj)
    for name, v in lj.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        leaves[name] if isinstance(v, tuple)
                        else (leaves[name],)):
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert leaves["sec_on"].all() and (leaves["mode"] == 1).all()
    np.testing.assert_array_equal(leaves["sec_idx"], phases)

    span = int(fs * 0.2)
    xs = x[head:]
    st_j, oj = ej.track_capture(jnp.asarray(to_planar(xs)),
                                _state_from_jax(leaves), span)
    st_t, ot = et.track_capture(torch.from_numpy(xs),
                                state_from_numpy(leaves, "cpu"), span)
    np.testing.assert_array_equal(ot.valid, oj.valid)
    v = oj.valid
    assert v.sum() >= 0.95 * 200 * 3
    np.testing.assert_array_equal(ot.start[v], oj.start[v])
    np.testing.assert_array_equal(ot.cur_len[v], oj.cur_len[v])
    np.testing.assert_array_equal(ot.active, oj.active)
    assert ot.active[-1].all()
    for name in ("carrier_doppler_hz", "rem_code_phase_samples"):
        np.testing.assert_allclose(getattr(ot, name)[v],
                                   getattr(oj, name)[v], rtol=0, atol=2e-2,
                                   err_msg=name)
    np.testing.assert_allclose(ot.code_freq_delta[v], oj.code_freq_delta[v],
                               rtol=F16_RTOL, atol=2e-2)
    sj, stn = _leaves(st_j), state_to_numpy(st_t)
    for name in ("start", "cur_len", "push_count", "active", "sec_on",
                 "sec_idx", "ext_cnt", "mode"):
        np.testing.assert_array_equal(stn[name], sj[name], err_msg=name)
    # the index advanced once per tracked epoch, modulo the code length
    n_ep = oj.valid.sum(axis=0)
    np.testing.assert_array_equal(stn["sec_idx"], (phases + n_ep) % n_sec)
    for name in ("carrier_doppler_hz", "code_freq_delta",
                 "rem_code_phase_samples"):
        np.testing.assert_allclose(stn[name], sj[name], rtol=0, atol=2e-2,
                                   err_msg=name)
    # with the wipe on and the data bits known, the loop stays locked on
    # the true Doppler
    for ch, s in enumerate(sats):
        assert abs(stn["carrier_doppler_hz"][ch] - s.doppler_hz) < 5.0
