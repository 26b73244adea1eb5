"""The port's chunked tracking engine against the JAX engine
(correlator='mxu', the same chunked math with its chain unrolled in XLA),
both started from the same mid-track state through state_from_numpy.

Bars: valid, start and cur_len exact; Doppler, code-frequency delta and
rem code phase at atol 2e-2; correlators at rtol 1e-4, atol 2e-2 (the bars
of tests/test_pallas_chain.py).  Fields that the JAX package ships as f16
(prompt, CN0, code-frequency delta, symbol means) at f16 resolution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
from gnss_sdr_1_tpu.utils.planar import to_planar
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import (state_from_numpy,
                                               state_to_numpy)
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 4.092e6
N_CH = 3
KW = dict(fs_hz=FS, code_length_chips=1023, chip_rate_chips_s=1.023e6,
          carrier_freq_hz=1575.42e6, n_channels=N_CH, chunk_epochs=8)
F16_RTOL = 2.0 ** -10        # one f16 ulp, relative


def _leaves(st):
    return {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=45.0,
                      nav_bits=rng.choice([-1.0, 1.0], size=16))
            for p in range(1, N_CH + 1)]
    codes = np.stack([gps_l1ca_code(p) for p in range(1, N_CH + 1)])
    x = generate_baseband(GPS_L1_CA, sats, {p: codes[p - 1]
                                            for p in range(1, N_CH + 1)},
                          FS, 0.12, noise=True)
    ej = JEngine(JTrackConfig(correlator="mxu", **KW), codes)
    et = TrackingEngine(TrackConfig(**KW), codes, device="cpu")
    st = ej.init_state()
    for ch, s in enumerate(sats):
        st = ej.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * FS,
                                 s.doppler_hz, 0, 0)
    # 40 ms of JAX tracking gives the mid-track state both engines start
    # from; channel 0 then switches to the narrow/extended mode
    head = int(FS * 0.04)
    st, _ = ej.track_capture(jnp.asarray(to_planar(x)), st, head)
    st = ej.enable_extended(st, 0, 7)
    return ej, et, codes, x[head:], _leaves(st)


def test_code_tables_bit_identical(setup):
    ej, et, codes, _, _ = setup
    np.testing.assert_array_equal(np.asarray(ej._rep_rows), et.rep_rows_np)
    assert et._lag_window == ej._lag_window
    assert et._corr_win == ej._corr_win
    assert et.capture_decim == ej.capture_decim


def test_state_round_trip(setup):
    _, _, _, _, leaves = setup
    back = state_to_numpy(state_from_numpy(leaves, "cpu"))
    assert set(back) == set(leaves)
    for k, v in leaves.items():
        if isinstance(v, tuple):
            for a, b in zip(v, back[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(v, back[k], err_msg=k)


def _close_f16(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=atol,
                               err_msg=what)


def test_track_capture_matches_jax(setup):
    ej, et, _, x, leaves = setup
    span = int(FS * 0.06)
    st_j, oj = ej.track_capture(jnp.asarray(to_planar(x)),
                                state_from_jax(ej, leaves), span)
    st_t, ot = et.track_capture(torch.from_numpy(x),
                                state_from_numpy(leaves, "cpu"), span)
    np.testing.assert_array_equal(ot.valid, oj.valid)
    v = oj.valid
    assert v.sum() > 0.9 * 60 * N_CH
    np.testing.assert_array_equal(ot.start[v], oj.start[v])
    np.testing.assert_array_equal(ot.cur_len[v], oj.cur_len[v])
    np.testing.assert_array_equal(ot.active, oj.active)
    for name in ("carrier_doppler_hz", "rem_code_phase_samples",
                 "rem_carr_phase_rad"):
        np.testing.assert_allclose(getattr(ot, name)[v],
                                   getattr(oj, name)[v], rtol=0, atol=2e-2,
                                   err_msg=name)
    _close_f16(ot.code_freq_delta[v], oj.code_freq_delta[v], 2e-2, "delta")
    _close_f16(ot.cn0_dbhz[v], oj.cn0_dbhz[v], 2e-2, "cn0")
    pj = oj.correlators[..., 1, 0] + 1j * oj.correlators[..., 1, 1]
    pt = ot.correlators[..., 1]
    _close_f16(pt.real[v], pj.real[v], 2e-2, "prompt I")
    _close_f16(pt.imag[v], pj.imag[v], 2e-2, "prompt Q")
    # final state
    sj, stn = _leaves(st_j), state_to_numpy(st_t)
    for name in ("start", "cur_len", "push_count", "mode", "ext_cnt",
                 "active"):
        np.testing.assert_array_equal(stn[name], sj[name], err_msg=name)
    for name in ("carrier_doppler_hz", "code_freq_delta",
                 "rem_code_phase_samples"):
        np.testing.assert_allclose(stn[name], sj[name], rtol=0, atol=2e-2,
                                   err_msg=name)


def state_from_jax(ej, leaves):
    """The JAX engine's own TrackState from the shared numpy leaves."""
    from gnss_sdr_1_tpu.track.engine import TrackState
    from gnss_sdr_1_tpu.track.loop_filter import FllPllState, IirState

    d = dict(leaves)
    d["carr_filter"] = FllPllState(*(jnp.asarray(a)
                                     for a in d["carr_filter"]))
    d["code_filter"] = IirState(*(jnp.asarray(a) for a in d["code_filter"]))
    return TrackState(**{k: (v if k in ("carr_filter", "code_filter")
                             else jnp.asarray(v)) for k, v in d.items()})


def test_track_capture_symbols_matches_jax(setup):
    ej, et, _, x, leaves = setup
    span = int(FS * 0.06)
    sym_off = np.array([20, 7, 13], dtype=np.int32)
    st_j, sj = ej.track_capture_symbols(jnp.asarray(to_planar(x)),
                                        state_from_jax(ej, leaves), span,
                                        sym_off, 20)
    st_t, stt = et.track_capture_symbols(torch.from_numpy(x),
                                         state_from_numpy(leaves, "cpu"),
                                         span, sym_off, 20)
    for name in ("start", "vcount", "n_valid", "active"):
        np.testing.assert_array_equal(getattr(stt, name), getattr(sj, name),
                                      err_msg=name)
    assert stt.vcount.sum() == stt.n_valid.sum() > 0.9 * 60 * N_CH
    for name in ("frac", "rem_carr_phase_rad", "carrier_doppler_hz"):
        np.testing.assert_allclose(getattr(stt, name), getattr(sj, name),
                                   rtol=0, atol=2e-2, err_msg=name)
    for name in ("mean_i", "mean_q", "cn0_dbhz", "code_freq_delta"):
        _close_f16(getattr(stt, name), getattr(sj, name), 2e-2, name)
    np.testing.assert_array_equal(np.asarray(st_t.start),
                                  np.asarray(st_j.start))
