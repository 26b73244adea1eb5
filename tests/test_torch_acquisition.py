"""The port's batched PCPS acquisition (torch.fft) against the JAX
package's on the same input: the same detections and Doppler bins, code
delays within one sample and test statistics at rtol 1e-4."""

import numpy as np
import pytest

from gnss_sdr_1_tpu.acquire import AcqConfig as JAcqConfig
from gnss_sdr_1_tpu.acquire import PcpsAcquisition as JPcps
from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.acquire import AcqConfig, PcpsAcquisition
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
PRESENT = [3, 7, 11, 19, 24]
SEARCH = list(range(1, 13)) + [19, 24]


@pytest.fixture(scope="module")
def capture():
    rng = np.random.default_rng(8)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-4500, 4500)),
                      delay_chips=float(rng.uniform(0, 1023)),
                      cn0_dbhz=float(rng.uniform(40.0, 47.0)))
            for p in PRESENT]
    x = generate_baseband(GPS_L1_CA, sats,
                          {p: gps_l1ca_code(p) for p in PRESENT}, FS, 0.006,
                          noise=True, seed=77)
    return sats, x


@pytest.mark.parametrize("two_steps,dwells,cfar", [
    (True, 2, False), (False, 2, False), (False, 1, True)])
def test_pcps_matches_jax(capture, two_steps, dwells, cfar):
    sats, x = capture
    kw = dict(fs_hz=FS, samples_per_code=2046, samples_per_chip=2,
              doppler_max_hz=5000.0, doppler_step_hz=250.0,
              max_dwells=dwells, use_cfar=cfar,
              threshold=0.002 if cfar else 2.0, make_two_steps=two_steps,
              doppler_step2_hz=40.0, num_doppler_bins_step2=10)
    codes = {p: gps_l1ca_code(p) for p in SEARCH}
    rj = JPcps(JAcqConfig(**kw), codes, fs_code_rate=(1.023e6, 1023)) \
        .acquire(x, samplestamp=17)
    acq = PcpsAcquisition(AcqConfig(**kw), codes,
                          fs_code_rate=(1.023e6, 1023), device="cpu")
    rt = acq.acquire(x, samplestamp=17)
    assert rt.samplestamp == 17
    np.testing.assert_array_equal(rt.positive, rj.positive)
    np.testing.assert_array_equal(rt.doppler_hz, rj.doppler_hz)
    assert np.abs(rt.delay_samples - rj.delay_samples).max() <= 1.0
    np.testing.assert_allclose(rt.test_stat, rj.test_stat, rtol=1e-4)
    # the satellites present are found within a coarse bin of their true
    # Doppler (a 1 ms coherent window resolves no finer than that)
    truth = {s.prn: s for s in sats}
    for k, prn in enumerate(acq.prns):
        if prn in truth and not cfar:
            assert rt.positive[k], prn
            assert abs(rt.doppler_hz[k] - truth[prn].doppler_hz) <= 250.0
