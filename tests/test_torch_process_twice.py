"""Two process() calls on the two halves of a capture: the port's sample
clock carries across calls as the JAX package's does (its receiver.py:
1256-1319): the second call's epochs are stamped after the first call's,
`_abs_base` ends at the samples consumed, and the symbol counts and every
decoded epoch's sample stamp are the JAX package's (correlator='mxu').  A
receiver in standby returns at once from process(), consuming nothing,
as the JAX package's does."""

import numpy as np
import pytest

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.constants import GPS_L1_CA
from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
from gnss_sdr_1_tpu.runtime import ReceiverConfig as JReceiverConfig
from gnss_sdr_1_tpu.siggen.generator import generate_baseband
from gnss_sdr_1_tpu.siggen.scenario import build_scenario
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 2.046e6
RX = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
PRNS = (3, 8, 14, 22)
KW = dict(fs_hz=FS, n_channels=len(PRNS), prn_search=PRNS)


@pytest.fixture(scope="module")
def twice(one_torch_thread):  # noqa: F811
    scen = build_scenario(RX, list(PRNS), t0_tow=345606.1,
                          duration_s=4.0 + 2e-3, cn0_dbhz=47.0,
                          subframe_cycle=(1, 2, 3))
    x = generate_baseband(GPS_L1_CA, scen.sats,
                          {p: gps_l1ca_code(p) for p in PRNS}, FS,
                          4.0 + 2e-3, noise=True, seed=1234)
    # two whole 1 s segments and one epoch's tail: every segment of both
    # calls has one length, so the JAX package compiles its capture once
    split = int(2 * FS) + 2 * int(FS * 1e-3)
    out = {}
    for name, rx in (
            ("jax", JReceiver(JReceiverConfig(correlator="mxu", **KW))),
            ("port", Receiver(ReceiverConfig(**KW), device="cpu"))):
        rx.process(x[:split])
        first = (rx._abs_base, dict(rx.sym_count))
        rx.process(x[rx._abs_base:])
        out[name] = rx, first
    return out


def test_second_call_continues_the_sample_clock(twice):
    (rj, (abs_j, syms_j)), (rt, (abs_t, syms_t)) = twice["jax"], \
        twice["port"]
    # the first call consumed its two whole segments
    assert abs_t == abs_j == int(2 * FS)
    assert syms_t == syms_j
    assert rt._abs_base == rj._abs_base > abs_t
    assert rt.channel_prn == rj.channel_prn
    assert rt.sym_count == rj.sym_count
    for prn, dj in rj.decoders.items():
        dt = rt.decoders[prn]
        assert dt.bit_offset == dj.bit_offset, prn
        sj = np.asarray(dj._sym.start_samples)
        st = np.asarray(dt._sym.start_samples)
        # the epoch stamps the observables are built on: exact, and the
        # second call's after the first call's
        np.testing.assert_array_equal(st, sj, err_msg=str(prn))
        assert np.all(np.diff(st) > 0), prn
        assert st[-1] > abs_t
        assert rt.last_rem[prn] == pytest.approx(rj.last_rem[prn], abs=2e-2)


def test_standby_returns_at_once():
    x = np.zeros(int(0.5 * FS), np.complex64)
    for rx in (JReceiver(JReceiverConfig(correlator="mxu", **KW)),
               Receiver(ReceiverConfig(**KW), device="cpu")):
        assert rx._standby is False
        rx.standby()
        assert rx.process(x) == []
        assert rx._abs_base == 0 and not rx.sym_count and not rx._acq_info
        rx.reset()
        assert rx._standby is False
