"""The port's signal conditioner (condition/, runtime.config.FrontEnd) on
the CPU against the JAX package's on the same inputs: the streaming
frequency-translating FIR at rtol 1e-5 of the output's max, block seams as
exact as the JAX package's own test holds them, the resamplers bit for bit,
pulse blanking, the notch and the beamformer at rtol 1e-5, and the two
GPS L1 conf frontends on 20 ms of signal."""

import pathlib

import numpy as np
import pytest

import gnss_sdr_1_tpu.condition.filters as jf
import gnss_sdr_1_tpu.condition.interference as ji
import gnss_sdr_1_tpu_torch.condition.filters as tf
import gnss_sdr_1_tpu_torch.condition.interference as ti
from gnss_sdr_1_tpu.runtime.config import FileConfiguration as JConf
from gnss_sdr_1_tpu.runtime.config import build_frontend as jbuild
from gnss_sdr_1_tpu_torch.runtime.config import FileConfiguration as TConf
from gnss_sdr_1_tpu_torch.runtime.config import build_frontend as tbuild
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CONF_DIR = pathlib.Path(__file__).resolve().parent.parent / "conf"
RTOL = 1e-5


def _noise(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _close(got, want, rtol=RTOL):
    """Elementwise agreement to rtol of the reference's max magnitude."""
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("if_hz", [0.0, 420e3])
@pytest.mark.parametrize("decim", [1, 2])
@pytest.mark.parametrize("block", [1 << 12, 1 << 14])
def test_conditioner_matches_jax(if_hz, decim, block):
    fs = 4.092e6
    x = _noise(30_011, 1)
    taps = tf.design_lowpass_fir(65, 0.45 * fs / decim, fs)
    want = jf.Conditioner(taps, fs, if_hz, decim, block_size=block).process(
        x, flush=True)
    got = tf.Conditioner(taps, fs, if_hz, decim, block_size=block,
                         device="cpu").process(x, flush=True)
    _close(got, want)


def test_conditioner_block_seams_exact():
    """Several blocks against one block holding the whole stream, at the
    JAX package's seam bar (test_condition.py::test_block_seams_are_exact,
    IF 0: with an IF the one-shot block's float32 mixer phase grows to
    ~1e4 rad and loses the bar by itself, in both packages)."""
    fs = 4.0e6
    x = _noise(50_000, 2)
    taps = tf.design_lowpass_fir(31, 0.8e6, fs)
    one = tf.Conditioner(taps, fs, 0.0, 2, block_size=1 << 16,
                         device="cpu").process(x, flush=True)
    many = tf.Conditioner(taps, fs, 0.0, 2, block_size=1 << 12,
                          device="cpu").process(x, flush=True)
    assert len(many) == len(one) == 25_000
    assert np.max(np.abs(many - one)) < 1e-4


@pytest.mark.parametrize("if_hz", [0.0, 420e3])
def test_conditioner_streamed_in_pieces(if_hz):
    """A stream fed in whole blocks over several calls, then flushed,
    equals one call: the history and the mixer phase carry exactly."""
    fs, blk = 4.0e6, 1 << 12
    x = _noise(50_000, 2)
    taps = tf.design_lowpass_fir(31, 0.8e6, fs)
    whole = tf.Conditioner(taps, fs, if_hz, 2, block_size=blk,
                           device="cpu").process(x, flush=True)
    cond = tf.Conditioner(taps, fs, if_hz, 2, block_size=blk, device="cpu")
    parts = [cond.process(x[:3 * blk]), cond.process(x[3 * blk:10 * blk]),
             cond.process(x[10 * blk:], flush=True)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_resamplers_bit_for_bit():
    x = _noise(10_007, 3)
    for fs_in, fs_out in ((4.0e6, 2.0e6), (4.092e6, 2.046e6),
                          (8.0e6, 2.6e6), (4.0e6, 2.5e6)):
        np.testing.assert_array_equal(tf.direct_resample(x, fs_in, fs_out),
                                      jf.direct_resample(x, fs_in, fs_out))
        np.testing.assert_array_equal(
            tf.fractional_resample(x, fs_in, fs_out),
            jf.fractional_resample(x, fs_in, fs_out))
    np.testing.assert_array_equal(tf.design_lowpass_fir(65, 1e6, 8e6),
                                  jf.design_lowpass_fir(65, 1e6, 8e6))


def test_pulse_blanking_matches_jax():
    x = _noise(20_000, 4, np.sqrt(0.5))
    x[5000:5050] += 50.0
    x[12_000:12_010] -= 30.0j
    yj, fj = ji.pulse_blanking(x, n_sigma=5.0)
    yt, ft = ti.pulse_blanking(x, n_sigma=5.0, device="cpu")
    _close(yt, yj)
    np.testing.assert_array_equal(yt == 0, yj == 0)
    assert ft == pytest.approx(fj, rel=RTOL)


def test_notch_matches_jax():
    n = 3 * (1 << 12) + 1000
    t = np.arange(n)
    x = (_noise(n, 5, np.sqrt(0.5))
         + 20.0 * np.exp(2j * np.pi * 0.123 * t)).astype(np.complex64)
    yj, fj = ji.notch_filter(x, excise_bw_bins=2, pfa_factor=30.0,
                             block=1 << 12)
    yt, ft = ti.notch_filter(x, excise_bw_bins=2, pfa_factor=30.0,
                             block=1 << 12, device="cpu")
    _close(yt, yj)
    assert ft == pytest.approx(fj, rel=RTOL) and ft > 0


def test_beamformer_matches_jax():
    x = _noise(2000 * 8, 7).reshape(2000, 8)
    w = tf.steering_weights(8, 0.5, 30.0)
    np.testing.assert_array_equal(w, jf.steering_weights(8, 0.5, 30.0))
    for weights in (None, w):
        want = jf.Beamformer(weights).process(x)
        got = tf.Beamformer(weights, device="cpu").process(x)
        _close(got, want)
    got = tf.Beamformer(device="cpu").process([x[:, i] for i in range(8)])
    _close(got, jf.Beamformer().process(x))
    with pytest.raises(ValueError):
        tf.Beamformer(device="cpu").process(x[:, :5])


@pytest.mark.parametrize("conf_name", ["gps_l1_if_xlating.conf",
                                       "gps_l1_ishort.conf"])
def test_frontend_process_matches_jax(conf_name):
    """20 ms of signal through the conf's SignalConditioner chain."""
    path = str(CONF_DIR / conf_name)
    fj, ft = jbuild(JConf(path)), tbuild(TConf(path))
    n = int(round(ft.source_fs_hz * 0.02))
    rng = np.random.default_rng(8)
    t = np.arange(n) / ft.source_fs_hz
    x = (_noise(n, 9) + 3.0 * np.exp(2j * np.pi * (ft.if_freq_hz + 1.5e3) * t
                                     + 1j * rng.uniform(0, 6))
         ).astype(np.complex64)
    want = fj.process(x)
    got = ft.process(x, device="cpu")
    assert not ft.is_passthrough
    _close(got, want)
