"""The port's acquisition variants (acquire/variants.py), PCPS Tong
(acquire/pcps.py acquire_tong) and the performance harnesses
(acquire/performance.py) against the JAX package's, on the CPU.

Each variant runs on the same numpy-seeded capture in both packages.  Bar
(ROADMAP.md, acquisition): the same detections and Doppler bins, delays
within 1 sample (circular), statistics to rtol 1e-4 (the FFTs and sums run
in another order).  The harnesses are held to the properties
tests/test_performance_harness.py checks of the JAX package's."""

import numpy as np
import pytest

from gnss_sdr_1_tpu import acquire as jacq
from gnss_sdr_1_tpu.codes import (galileo_e1_sinboc11, galileo_e1b_code,
                                  galileo_e1c_code, gps_l1ca_code)
from gnss_sdr_1_tpu.codes.sampling import resample_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch import acquire as tacq
from gnss_sdr_1_tpu_torch.acquire import performance as tperf
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
SPC = 2046
E1_SPC = 8184          # one 4 ms E1 period at FS
PRNS = (3, 7, 23)


def _same(rt, rj, spc, what):
    """The acquisition bar between the port's result and the JAX one."""
    np.testing.assert_array_equal(rt.positive, rj.positive, err_msg=what)
    np.testing.assert_array_equal(np.ravel(rt.doppler_hz),
                                  np.ravel(rj.doppler_hz), err_msg=what)
    dd = np.abs(np.ravel(rt.delay_samples) - np.ravel(rj.delay_samples))
    dd = np.minimum(dd, spc - dd)
    assert (dd <= 1.0).all(), (what, dd)
    np.testing.assert_allclose(rt.test_stat, rj.test_stat, rtol=1e-4,
                               err_msg=what)
    assert rt.samplestamp == rj.samplestamp


@pytest.fixture(scope="module")
def gps_capture():
    sats = [SatParams(prn=7, doppler_hz=1437.0, delay_chips=513.25,
                      cn0_dbhz=50.0),
            SatParams(prn=3, doppler_hz=-2210.0, delay_chips=97.6,
                      cn0_dbhz=47.0)]
    codes = {s.prn: gps_l1ca_code(s.prn) for s in sats}
    return generate_baseband(GPS_L1_CA, sats, codes, FS, 0.012, noise=True,
                             seed=11)


def _gps_cfg(**kw):
    base = dict(fs_hz=FS, samples_per_code=SPC, samples_per_chip=2,
                doppler_max_hz=5000.0, doppler_step_hz=250.0,
                use_cfar=False, threshold=2.0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def e1_capture():
    """Two E1 satellites (data + pilot sinBOC components) at FS, with a
    data-symbol sign flip at the first code-period boundary of PRN 11."""
    rng = np.random.default_rng(5)
    n = np.arange(3 * E1_SPC)
    x = np.zeros(len(n), np.complex128)
    for prn, delay, dop, flip in ((11, 4000, 875.0, -1.0),
                                  (19, 7001, -1250.0, 1.0)):
        b = resample_code(galileo_e1_sinboc11(galileo_e1b_code(prn)), FS,
                          2.046e6, E1_SPC)
        c = resample_code(galileo_e1_sinboc11(galileo_e1c_code(prn)), FS,
                          2.046e6, E1_SPC)
        sym = np.repeat([1.0, flip, 1.0], E1_SPC)
        comp = sym * np.tile(np.roll(b, delay), 3) \
            + np.tile(np.roll(c, delay), 3)
        x += comp * np.exp(2j * np.pi * dop * n / FS)
    x += 0.8 * (rng.normal(size=len(n)) + 1j * rng.normal(size=len(n)))
    return x.astype(np.complex64)


def _e1_codes(prns, pilot=False):
    gen = galileo_e1c_code if pilot else galileo_e1b_code
    return {p: resample_code(galileo_e1_sinboc11(gen(p)), FS, 2.046e6,
                             E1_SPC) for p in prns}


def _e1_cfg(**kw):
    base = dict(fs_hz=FS, samples_per_code=E1_SPC, samples_per_chip=2,
                doppler_max_hz=2000.0, doppler_step_hz=250.0,
                use_cfar=False, threshold=1.5)
    base.update(kw)
    return base


@pytest.mark.parametrize("fold", [2, 3])
def test_quicksync_matches_jax(gps_capture, fold):
    kw = _gps_cfg(use_cfar=True, pfa=0.001)
    codes = {p: gps_l1ca_code(p) for p in PRNS}
    rj = jacq.QuickSyncAcquisition(
        jacq.AcqConfig(**kw), codes, folding_factor=fold,
        fs_code_rate=(1.023e6, 1023)).acquire(gps_capture, samplestamp=9)
    rt = tacq.QuickSyncAcquisition(
        tacq.AcqConfig(**kw), codes, folding_factor=fold,
        fs_code_rate=(1.023e6, 1023), device="cpu").acquire(
            gps_capture, samplestamp=9)
    _same(rt, rj, SPC, f"quicksync fold {fold}")
    assert rt.positive[PRNS.index(7)]


def test_quicksync_e1_fold2_matches_jax(e1_capture):
    kw = _e1_cfg()
    codes = {p: galileo_e1_sinboc11(galileo_e1b_code(p)) for p in (11, 19)}
    rj = jacq.QuickSyncAcquisition(
        jacq.AcqConfig(**kw), codes, folding_factor=2,
        fs_code_rate=(2.046e6, 8184)).acquire(e1_capture)
    rt = tacq.QuickSyncAcquisition(
        tacq.AcqConfig(**kw), codes, folding_factor=2,
        fs_code_rate=(2.046e6, 8184), device="cpu").acquire(e1_capture)
    _same(rt, rj, E1_SPC, "quicksync E1")


def test_cccwsr_matches_jax(e1_capture):
    # the statistic is max|corr|^2 / (F^2 mean|x|^2): ~0.08 for these
    # components in this noise, ~1e-3 for an absent PRN
    kw = _e1_cfg(bit_transition_flag=True, threshold=0.01)
    prns = (11, 19, 24)
    args = (_e1_codes(prns), _e1_codes(prns, pilot=True))
    rj = jacq.CccwsrAcquisition(jacq.AcqConfig(**kw), *args).acquire(
        e1_capture)
    rt = tacq.CccwsrAcquisition(tacq.AcqConfig(**kw), *args,
                                device="cpu").acquire(e1_capture)
    _same(rt, rj, E1_SPC, "cccwsr")
    assert rt.positive[0] and rt.positive[1] and not rt.positive[2]


def test_pcps_8ms_matches_jax(e1_capture):
    kw = _e1_cfg(sampled_ms=2, threshold=0.01)
    codes = _e1_codes((11, 19, 24))
    rj = jacq.Pcps8msAcquisition(jacq.AcqConfig(**kw), codes).acquire(
        e1_capture)
    rt = tacq.Pcps8msAcquisition(tacq.AcqConfig(**kw), codes,
                                 device="cpu").acquire(e1_capture)
    _same(rt, rj, E1_SPC, "8ms")
    assert rt.positive[0] and rt.positive[1] and not rt.positive[2]


def test_fine_doppler_matches_jax(gps_capture):
    """The JAX package returns the fine Doppler as a [1, C] row when more
    than one PRN is searched; the port returns [C] with the same values."""
    kw = _gps_cfg(make_two_steps=False)
    codes = {p: gps_l1ca_code(p) for p in PRNS}
    pj = jacq.PcpsAcquisition(jacq.AcqConfig(**kw), codes,
                              fs_code_rate=(1.023e6, 1023))
    pt = tacq.PcpsAcquisition(tacq.AcqConfig(**kw), codes,
                              fs_code_rate=(1.023e6, 1023), device="cpu")
    rj = jacq.FineDopplerAcquisition(pj).acquire(gps_capture)
    rt = tacq.FineDopplerAcquisition(pt).acquire(gps_capture)
    assert np.shape(rt.doppler_hz) == (len(PRNS),)
    _same(rt, rj, SPC, "fine doppler")
    k = PRNS.index(7)
    assert rt.positive[k] and abs(rt.doppler_hz[k] - 1437.0) <= 30.0


@pytest.mark.parametrize("use_cfar", [False, True])
def test_tong_matches_jax(gps_capture, use_cfar):
    kw = _gps_cfg(use_cfar=use_cfar, pfa=0.001 if use_cfar else 0.0,
                  threshold=0.0 if use_cfar else 2.0)
    codes = {p: gps_l1ca_code(p) for p in PRNS}
    args = dict(tong_init=1, tong_max=3, samplestamp=4)
    rj = jacq.PcpsAcquisition(jacq.AcqConfig(**kw), codes,
                              fs_code_rate=(1.023e6, 1023)).acquire_tong(
        gps_capture, **args)
    rt = tacq.PcpsAcquisition(tacq.AcqConfig(**kw), codes,
                              fs_code_rate=(1.023e6, 1023),
                              device="cpu").acquire_tong(gps_capture, **args)
    _same(rt, rj, SPC, f"tong cfar={use_cfar}")
    assert rt.positive[PRNS.index(7)]


@pytest.mark.parametrize("window", [0.0, 3000.0])
def test_caf_matches_jax(window):
    """CAF at an E5a-like shape (1 ms periods, I and Q codes) on seeded
    random +-1 codes and a composite I + jQ signal."""
    rng = np.random.default_rng(3)
    spc = 2046
    prns = (3, 8)
    di = {p: rng.choice([-1.0, 1.0], size=spc).astype(np.float32)
          for p in prns}
    dq = {p: rng.choice([-1.0, 1.0], size=spc).astype(np.float32)
          for p in prns}
    n = np.arange(spc)
    comp = np.roll(di[3], 1234) + 1j * np.roll(dq[3], 1234)
    x = (comp * np.exp(2j * np.pi * 1500.0 * n / FS)
         + (rng.normal(size=spc) + 1j * rng.normal(size=spc))).astype(
             np.complex64)
    kw = _gps_cfg(samples_per_code=spc, use_cfar=True, pfa=0.001)
    rj = jacq.CafAcquisition(jacq.AcqConfig(**kw), di, dq,
                             caf_window_hz=window).acquire(x)
    rt = tacq.CafAcquisition(tacq.AcqConfig(**kw), di, dq,
                             caf_window_hz=window, device="cpu").acquire(x)
    _same(rt, rj, spc, f"caf window {window}")
    assert rt.positive[0]
    assert abs(rt.doppler_hz[0] - 1500.0) <= 250.0


def test_roc_monotone_in_cn0():
    pts = tperf.acquisition_roc(cn0_grid=(33.0, 45.0), n_trials=6,
                                threshold=2.0, fs_hz=FS, device="cpu")
    lo, hi = pts
    assert hi.pd >= lo.pd
    assert hi.pd == 1.0
    assert hi.mean_stat_present > 2.0 * hi.mean_stat_absent
    assert lo.pfa <= 0.5 and hi.pfa <= 0.5


def test_pull_in_map_center_locks():
    pts = tperf.tracking_pull_in_map(doppler_errs=(0.0, 150.0),
                                     delay_errs=(0.0, 0.75), duration_s=1.2,
                                     fs_hz=FS, device="cpu")
    by_key = {(p.doppler_err_hz, p.delay_err_chips): p for p in pts}
    assert by_key[(0.0, 0.0)].locked
    assert len(pts) == 4
