"""The port's tracking chain (ops/track_chain.py) against the JAX package's
Pallas chain kernel run in interpret mode, on the same inputs: random lag
windows around a correlation peak and the packed state of channels that the
JAX engine tracked.  Covers PLL order 2 and 3, wide and narrow/extended
mode, the in-loop secondary wipe, a lock-fail drop, a dead channel and the
sample limit.

The inputs are made in the Pallas kernel's layout (lag windows [E, LW, C],
slice origins [E, C], step0 [1, C]) and permuted into the port's
channel-major one ([C, E, LW], [C, E], [C]).

Tolerances: int rows and flags exact; float32 rows at atol 1e-4 of the
row's scale (the port uses atan2 where the TPU kernel uses the Cephes
rational, <= 4e-7 rad apart, and sums taps in another order).  The CUDA
case (kernel against plain on the card) skips without a GPU; it imports
nothing of JAX, so on a GPU machine without JAX it runs as
    python -m pytest --noconftest -m gpu tests/test_torch_chain.py"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.ops import track_chain as tc
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy
from gnss_sdr_1_tpu_torch.track.loop_filter import fll_pll_coefficients

FS = 4.092e6
C = 4
E = 8
KW = dict(fs_hz=FS, code_length_chips=1023, chip_rate_chips_s=1.023e6,
          carrier_freq_hz=1575.42e6, n_channels=C, chunk_epochs=E)


def _capture():
    rng = np.random.default_rng(21)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=45.0)
            for p in range(1, C + 1)]
    codes = np.stack([gps_l1ca_code(p) for p in range(1, C + 1)])
    x = generate_baseband(GPS_L1_CA, sats, {p: codes[p - 1]
                                            for p in range(1, C + 1)},
                          FS, 0.05, noise=True)
    return sats, codes, x


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX package's Pallas chain module (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from gnss_sdr_1_tpu.ops import pallas_chain

    return pallas_chain


@pytest.fixture(scope="module")
def tracked_state(jax_chain):
    """Packed (fst, ist) rows of 4 channels after 40 ms of JAX tracking."""
    import jax.numpy as jnp

    from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
    from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
    from gnss_sdr_1_tpu.utils.planar import to_planar

    sats, codes, x = _capture()
    ej = JEngine(JTrackConfig(correlator="mxu", **KW), codes)
    st = ej.init_state()
    for ch, s in enumerate(sats):
        st = ej.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * FS,
                                 s.doppler_hz, 0, 0)
    st, _ = ej.track_capture(jnp.asarray(to_planar(x)), st, int(FS * 0.04))
    leaves = {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                  else np.asarray(v)) for k, v in st._asdict().items()}
    et = TrackingEngine(TrackConfig(**KW), codes, device="cpu")
    fst, ist = et._pack_rows(state_from_numpy(leaves, "cpu"), 10 ** 6)
    return et.chain_spec, fst.numpy(), ist.numpy()


@pytest.fixture(scope="module")
def port_state():
    """The same rows after 40 ms of tracking by the port's own engine."""
    sats, codes, x = _capture()
    et = TrackingEngine(TrackConfig(**KW), codes, device="cpu")
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * FS,
                                 s.doppler_hz, 0, 0)
    st, _ = et.track_capture(torch.from_numpy(x), st, int(FS * 0.04))
    fst, ist = et._pack_rows(st, 10 ** 6)
    return et.chain_spec, fst.numpy(), ist.numpy()


def _case(tracked_state, case, seed):
    """ChainSpec + numpy inputs for one scenario."""
    spec, fst, ist = tracked_state
    fst, ist = fst.copy(), ist.copy()
    rng = np.random.default_rng(seed)
    if case["order"] == 2:
        w = fll_pll_coefficients(35.0, 25.0, 2)
        n = fll_pll_coefficients(8.0, 12.0, 2)
        spec = dataclasses.replace(
            spec, order=2,
            wide=(w.w0p, w.w0p2, w.w0p3, w.w0f, w.w0f2, w.a2, w.a3, w.b3),
            narrow=(n.w0p, n.w0p2, n.w0p3, n.w0f, n.w0f2, n.a2, n.a3, n.b3))
        # order-2 integrator seeding (w carries the Doppler)
        fst[tc.F_CARR_W] = fst[tc.F_DOPPLER]
        fst[tc.F_CARR_X] = 0.0
    sec = np.ones((1, C), np.float32)
    if case.get("sec"):
        spec = dataclasses.replace(spec, sec_len=20)
        sec = rng.choice([-1.0, 1.0], size=(20, C)).astype(np.float32)
        ist[tc.I_SEC_ON, 2] = 1
        ist[tc.I_SEC_IDX, 2] = 17
    if case.get("narrow"):
        # ch1: boundary inside the chunk; ch2: passes the half window too
        ist[tc.I_MODE, 1:3] = 1
        ist[tc.I_EXTCNT, 1] = 15
        ist[tc.I_EXTCNT, 2] = 6
        ist[tc.I_FLL_ON, 1] = 1
        ist[tc.I_PUSH, 1] = 3
    if case.get("lockfail"):
        spec = dataclasses.replace(spec, max_lock_fail=0)
        ist[tc.I_PUSH, 3] = spec.cn0_samples - 1
        ist[tc.I_FLL_ON, 3] = 0
        fst[[tc.F_SABSI, tc.F_SI2, tc.F_SQ2], 3] = 0.0
    if case.get("dead"):
        ist[tc.I_ACTIVE, 0] = 0
    start = ist[tc.I_START].astype(np.int64)
    if case.get("limit"):
        # ch1 runs out of samples after 3 epochs
        ist[tc.I_LIMIT, 1] = int(start[1] + 3 * spec.t0_int - 10)
    # regular-grid slice origins and lag windows with a correlation peak
    # where the taps read (lag_margin + grid offset + rem_code)
    s_reg = (start[None, :] - (E + 4)
             + np.arange(E)[:, None] * spec.t0_int).astype(np.int32)
    lag = np.arange(spec.LW)[None, :, None]
    pk = (spec.lag_margin + (E + 4) + fst[tc.F_REM_CODE])[None, None, :]
    tri = np.maximum(0.0, 1.0 - np.abs(lag - pk) / spec.spc_samples)
    amp = rng.normal(size=(E, 1, C)) * 20.0 + 300.0
    ph = rng.uniform(-0.3, 0.3, size=(E, 1, C))
    zr = (amp * np.cos(ph) * tri
          + rng.normal(size=(E, spec.LW, C)) * 10.0).astype(np.float32)
    zi = (amp * np.sin(ph) * tri
          + rng.normal(size=(E, spec.LW, C)) * 10.0).astype(np.float32)
    if case.get("lockfail"):
        zr[..., 3] = rng.normal(size=(E, spec.LW)) * 10.0
        zi[..., 3] = rng.normal(size=(E, spec.LW)) * 10.0
    step0 = (2 * np.pi * (fst[tc.F_DOPPLER] + 0.7) / FS)[None].astype(
        np.float32)
    args = (zr, zi, s_reg, step0, sec, fst, ist)
    return dataclasses.replace(spec, C=C), args


def _port_args(args):
    """The port's layout of one case's inputs, as torch tensors."""
    zr, zi, s_reg, step0, sec, fst, ist = args
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        zr.transpose(2, 0, 1), zi.transpose(2, 0, 1), s_reg.T, step0[0],
        sec, fst, ist))


CASES = {
    "wide_order3": dict(order=3, dead=True),
    "wide_order2_limit": dict(order=2, limit=True),
    "narrow_sec_order3": dict(order=3, narrow=True, sec=True),
    "narrow_order2_lockfail": dict(order=2, narrow=True, lockfail=True),
}


def _compare(got, want, what):
    names = ("out_f", "out_i", "out_corr", "fst", "ist")
    for name, g, w in zip(names, got, want):
        g = np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (what, name)
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        rows = g.shape[-2]
        for r in range(rows):
            gr, wr = g[..., r, :], w[..., r, :]
            if name == "out_f" and r in (tc.O_VALID, tc.O_ACTIVE):
                np.testing.assert_array_equal(gr, wr, err_msg=f"{what} {r}")
                continue
            scale = max(1.0, float(np.abs(wr).max()))
            np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{what} {name} row {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_plain_matches_pallas_interpret(jax_chain, tracked_state,
                                              case):
    import jax.numpy as jnp

    spec, args = _case(tracked_state, CASES[case], seed=len(case))
    jspec = jax_chain.ChainSpec(**dataclasses.asdict(spec))
    want = jax_chain.make_chain_call(jspec, interpret=True)(
        *(jnp.asarray(a) for a in args))
    got = tc.chain(spec, *_port_args(args))
    _compare(got, want, case)
    ist_out = np.asarray(got[4])
    out_f = np.asarray(got[0])
    if CASES[case].get("dead"):
        assert not out_f[:, tc.O_VALID, 0].any()
        np.testing.assert_array_equal(np.asarray(got[3])[:, 0], args[5][:, 0])
    if CASES[case].get("limit"):
        assert out_f[:, tc.O_VALID, 1].sum() == 3
    if CASES[case].get("lockfail"):
        assert ist_out[tc.I_ACTIVE, 3] == 0
        assert out_f[-1, tc.O_ACTIVE, 3] == 0.0
    if CASES[case].get("narrow"):
        # ch1 closed its extended window inside the chunk
        assert ist_out[tc.I_PUSH, 1] > args[6][tc.I_PUSH, 1]


def test_chain_wrapper_counts_only_kernel_launches(port_state):
    spec, args = _case(port_state, CASES["wide_order3"], seed=3)
    port = _port_args(args)
    before = tc.launches
    tc.chain(spec, *port)
    assert tc.launches == before
    with pytest.raises(ValueError):
        tc.chain(spec, *port[:-1], port[-1].to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_kernel_matches_plain_on_gpu(port_state, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA chain kernel has no CPU "
                    "mode)")
    spec, args = _case(port_state, CASES[case], seed=len(case))
    dev = [t.cuda() for t in _port_args(args)]
    before = tc.launches
    got = tc.chain(spec, *dev)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    want = tc.chain_plain(spec, *dev)
    _compare([t.cpu() for t in got], [t.cpu() for t in want], case)
