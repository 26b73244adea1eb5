"""The port's tracking primitives (discriminators, lock detectors, loop
filters) against the JAX package's on the same random inputs.

Tolerance: rtol 1e-6 (float32 transcendentals of two libraries differ by an
ulp or two); an absolute floor of 1e-6 of the output scale covers results
that cancel to near zero."""

import numpy as np
import pytest
import torch

import gnss_sdr_1_tpu.track.discriminators as jd
import gnss_sdr_1_tpu.track.lock_detectors as jl
import gnss_sdr_1_tpu.track.loop_filter as jf
import gnss_sdr_1_tpu_torch.track.discriminators as td
import gnss_sdr_1_tpu_torch.track.lock_detectors as tl
import gnss_sdr_1_tpu_torch.track.loop_filter as tf


def _close(got, want, rtol=1e-6):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


def _cplx(rng, shape, zeros=True):
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 50.0
    if zeros:
        z.flat[0] = 0.0                        # I == Q == 0
        z.flat[1] = 1j * 3.0                   # I == 0
        z.flat[2] = -4.0                       # Q == 0, I < 0
    return z.astype(np.complex64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_discriminators_match(seed):
    rng = np.random.default_rng(seed)
    p1, p2, p3, p4 = (_cplx(rng, (64,)) for _ in range(4))
    t = {k: torch.from_numpy(v) for k, v in
         dict(p1=p1, p2=p2, p3=p3, p4=p4).items()}
    _close(td.pll_cloop_two_quadrant_atan(t["p1"]),
           jd.pll_cloop_two_quadrant_atan(p1))
    _close(td.pll_four_quadrant_atan(t["p1"]), jd.pll_four_quadrant_atan(p1))
    _close(td.fll_four_quadrant_atan(t["p1"], t["p2"], 0.0, 1e-3),
           jd.fll_four_quadrant_atan(p1, p2, 0.0, 1e-3))
    _close(td.dll_nc_e_minus_l_normalized(t["p1"], t["p2"]),
           jd.dll_nc_e_minus_l_normalized(p1, p2))
    _close(td.dll_nc_vemlp_normalized(t["p1"], t["p2"], t["p3"], t["p4"]),
           jd.dll_nc_vemlp_normalized(p1, p2, p3, p4))


@pytest.mark.parametrize("coh", [1e-3, 20e-3])
def test_lock_detectors_match(coh):
    rng = np.random.default_rng(4)
    buf = _cplx(rng, (8, 20), zeros=False)
    buf.real += 80.0                           # partially locked prompts
    tb = torch.from_numpy(buf)
    _close(tl.cn0_svn_estimator(tb, coh), jl.cn0_svn_estimator(buf, coh))
    _close(tl.carrier_lock_detector(tb), jl.carrier_lock_detector(buf))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("last_integrator", [False, True])
def test_iir_filter_matches(order, last_integrator):
    bi_j, bo_j = jf.iir_coefficients(2.0, 1e-3, order, last_integrator)
    bi_t, bo_t = tf.iir_coefficients(2.0, 1e-3, order, last_integrator)
    np.testing.assert_array_equal(bi_j, bi_t)
    np.testing.assert_array_equal(bo_j, bo_t)
    rng = np.random.default_rng(order)
    sj = jf.iir_init((16,))
    st = tf.iir_init((16,))
    for _ in range(30):
        u = rng.normal(size=16).astype(np.float32)
        sj, yj = jf.iir_apply(sj, u, bi_j, bo_j)
        st, yt = tf.iir_apply(st, torch.from_numpy(u),
                              torch.from_numpy(bi_t), torch.from_numpy(bo_t))
        _close(yt, yj)
    _close(st.inputs, sj.inputs)
    _close(st.outputs, sj.outputs)
    mask = np.arange(16) % 2 == 0
    rj = jf.iir_reset(sj, 5.0, mask)
    rt = tf.iir_reset(st, 5.0, torch.from_numpy(mask))
    _close(rt.inputs, rj.inputs)
    _close(rt.outputs, rj.outputs)


@pytest.mark.parametrize("order", [2, 3])
def test_fll_pll_filter_matches(order):
    cj = jf.fll_pll_coefficients(10.0, 25.0, order)
    ct = tf.fll_pll_coefficients(10.0, 25.0, order)
    assert tuple(cj) == tuple(ct)
    rng = np.random.default_rng(10 + order)
    dop = rng.uniform(-4000, 4000, size=12).astype(np.float32)
    sj = jf.fll_pll_init(cj, dop, (12,))
    st = tf.fll_pll_init(ct, torch.from_numpy(dop), (12,))
    _close(st.w, sj.w)
    _close(st.x, sj.x)
    for _ in range(40):
        fll = (rng.normal(size=12) * 5.0).astype(np.float32)
        pll = (rng.normal(size=12) * 0.05).astype(np.float32)
        sj, ej = jf.fll_pll_apply(sj, cj, fll, pll, np.float32(1e-3))
        st, et = tf.fll_pll_apply(st, ct, torch.from_numpy(fll),
                                  torch.from_numpy(pll), 1e-3)
        _close(et, ej)
    _close(st.w, sj.w)
    _close(st.x, sj.x)
