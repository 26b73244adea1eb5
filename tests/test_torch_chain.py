"""The port's tracking chain (ops/track_chain.py) against the JAX package's
Pallas chain kernel run in interpret mode, on the same inputs: random lag
windows around a correlation peak and the packed state of channels that the
JAX engine tracked.  Covers PLL order 2 and 3, wide and narrow/extended
mode, the in-loop secondary wipe, a lock-fail drop, a dead channel and the
sample limit, at 3 taps (GPS L1 C/A, EPL) and at 5 (Galileo E1B, VEML:
the state of E1 channels the JAX engine tracked, with and without a
secondary code); and the real data-channel secondary codes of GPS L5I
(NH10, which does not divide the 16 epochs of a chunk) and Galileo E5a-I
(CS20) over consecutive chunks, each implementation carrying its own state
across the seams.

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

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code, tracking_replica
from gnss_sdr_1_tpu_torch.constants import GALILEO_E1B, GPS_L1_CA
from gnss_sdr_1_tpu_torch.ops import track_chain as tc
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy
from gnss_sdr_1_tpu_torch.track.loop_filter import fll_pll_coefficients
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 4.092e6
C = 4
E = 8
KW = dict(fs_hz=FS, code_length_chips=1023, chip_rate_chips_s=1.023e6,
          carrier_freq_hz=1575.42e6, n_channels=C, chunk_epochs=E)
# Galileo E1B at 4 Msps: the sinBOC(1,1) replica at 2 samples per chip,
# 5 taps, 4 ms epochs
FS_E1 = 4.0e6
KW_E1 = dict(fs_hz=FS_E1, code_length_chips=4092, chip_rate_chips_s=1.023e6,
             carrier_freq_hz=1575.42e6, n_channels=C, chunk_epochs=E,
             code_samples_per_chip=2, veml=True, early_late_space_chips=0.15,
             very_early_late_space_chips=0.6)


def _capture(veml=False):
    """(satellites, replica table, capture, engine keywords, seconds to
    track before the chain's inputs are taken)."""
    rng = np.random.default_rng(21)
    if veml:
        spec = dataclasses.replace(GALILEO_E1B, code_rate_chips_s=2.046e6,
                                   code_length_chips=8184, bit_rate_bps=250.0)
        span, fs, kw, head = 8184.0, FS_E1, KW_E1, 0.048
        codes = np.stack([tracking_replica("1B", p)[0]
                          for p in range(1, C + 1)])
    else:
        spec, span, fs, kw, head = GPS_L1_CA, 1023.0, FS, KW, 0.04
        codes = np.stack([gps_l1ca_code(p) for p in range(1, C + 1)])
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, span)), cn0_dbhz=45.0)
            for p in range(1, C + 1)]
    x = generate_baseband(spec, sats, {p: codes[p - 1]
                                       for p in range(1, C + 1)},
                          fs, head + 0.02, noise=True)
    return sats, codes, x, kw, head


def _delay_samples(s, kw):
    return s.delay_chips / (kw["chip_rate_chips_s"]
                            * kw.get("code_samples_per_chip", 1)) \
        * kw["fs_hz"]


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX package's Pallas chain module (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from gnss_sdr_1_tpu.ops import pallas_chain

    return pallas_chain


def _jax_tracked(veml):
    """Packed (fst, ist) rows of 4 channels after 40 ms (GPS) or 48 ms
    (E1) of JAX tracking."""
    import jax.numpy as jnp

    from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
    from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
    from gnss_sdr_1_tpu.utils.planar import to_planar

    sats, codes, x, kw, head = _capture(veml)
    ej = JEngine(JTrackConfig(correlator="mxu", **kw), codes)
    st = ej.init_state()
    for ch, s in enumerate(sats):
        st = ej.activate_channel(st, ch, ch, _delay_samples(s, kw),
                                 s.doppler_hz, 0, 0)
    st, _ = ej.track_capture(jnp.asarray(to_planar(x)), st,
                             int(kw["fs_hz"] * head))
    leaves = {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                  else np.asarray(v)) for k, v in st._asdict().items()}
    et = TrackingEngine(TrackConfig(**kw), codes, device="cpu")
    fst, ist = et._pack_rows(state_from_numpy(leaves, "cpu"), 10 ** 6)
    return et.chain_spec, fst.numpy(), ist.numpy()


def _port_tracked(veml):
    """The same rows after the same tracking by the port's own engine."""
    sats, codes, x, kw, head = _capture(veml)
    et = TrackingEngine(TrackConfig(**kw), codes, device="cpu")
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, _delay_samples(s, kw),
                                 s.doppler_hz, 0, 0)
    st, _ = et.track_capture(torch.from_numpy(x), st,
                             int(kw["fs_hz"] * head))
    fst, ist = et._pack_rows(st, 10 ** 6)
    return et.chain_spec, fst.numpy(), ist.numpy()


@pytest.fixture(scope="module")
def tracked_state(jax_chain):
    return _jax_tracked(False)


@pytest.fixture(scope="module")
def tracked_state_veml(jax_chain):
    return _jax_tracked(True)


@pytest.fixture(scope="module")
def port_state():
    return _port_tracked(False)


@pytest.fixture(scope="module")
def port_state_veml():
    return _port_tracked(True)


def _state(request, base, case):
    """The tracked-state fixture `base` at the case's tap count."""
    return request.getfixturevalue(base + ("_veml" if case.get("veml")
                                           else ""))


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
    step0 = (2 * np.pi * (fst[tc.F_DOPPLER] + 0.7) / spec.fs)[None].astype(
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
    "veml_order3": dict(veml=True, order=3, dead=True),
    "veml_sec_order2_limit": dict(veml=True, order=2, sec=True, limit=True),
}


def _compare(got, want, what, pairs=None):
    """`pairs` maps an output's name to (real row, imaginary row) pairs
    that share one scale, the larger of the two rows' maxima."""
    names = ("out_f", "out_i", "out_corr", "fst", "ist")
    for name, g, w in zip(names, got, want):
        g = np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (what, name)
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        rows = g.shape[-2]
        partner = {}
        for a, b in (pairs or {}).get(name, ()):
            partner[a], partner[b] = b, a
        for r in range(rows):
            gr, wr = g[..., r, :], w[..., r, :]
            if name == "out_f" and r in (tc.O_VALID, tc.O_ACTIVE):
                np.testing.assert_array_equal(gr, wr, err_msg=f"{what} {r}")
                continue
            scale = max(1.0, float(np.abs(wr).max()))
            if r in partner:
                scale = max(scale, float(np.abs(w[..., partner[r], :]).max()))
            np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{what} {name} row {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_plain_matches_pallas_interpret(jax_chain, request, case):
    import jax.numpy as jnp

    spec, args = _case(_state(request, "tracked_state", CASES[case]),
                       CASES[case], seed=len(case))
    assert spec.K == (5 if CASES[case].get("veml") else 3)
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


# the data-channel secondary codes the chain wipes on GPS L5I and Galileo
# E5a-I, over SEC_CHUNKS consecutive 16-epoch chunks
SEC_CODES = ("nh10", "cs20")
SEC_CHUNKS = 3


def _sec_code(name):
    from gnss_sdr_1_tpu_torch.codes import NH10
    from gnss_sdr_1_tpu_torch.codes.galileo_e5 import galileo_e5ai_secondary

    return np.asarray(NH10 if name == "nh10" else galileo_e5ai_secondary(),
                      np.float32)


def _sec_setup(tracked_state, name):
    """The chain of a 16-epoch engine that wipes `name` (extension window
    = the code's length, Costas discriminator), the tracked state with the
    wipe on at several code indices (ch0 and ch1 in the extended mode, the
    window closing inside the first chunk on ch0; ch2 wide; ch3 without
    the wipe), and the per-channel secondary rows [sec_len, C]."""
    sec = _sec_code(name)
    n = len(sec)
    codes = np.stack([gps_l1ca_code(p) for p in range(1, C + 1)])
    eng = TrackingEngine(TrackConfig(**{
        **KW, "chunk_epochs": 16, "extend_correlation_symbols": n,
        "sec_data": True}), codes, sec_codes=np.tile(sec, (C, 1)),
        device="cpu")
    spec = eng.chain_spec
    assert (spec.E, spec.sec_len, spec.ext_n, spec.sec_data) == (
        16, n, n, True)
    _, fst, ist = tracked_state
    fst, ist = fst.copy(), ist.copy()
    ist[tc.I_SEC_ON, :3] = 1
    ist[tc.I_SEC_IDX, :3] = (n - 1, 3, 0)
    ist[tc.I_MODE, :2] = 1
    ist[tc.I_EXTCNT, :2] = (n - 2, 4)
    return spec, fst, ist, np.ascontiguousarray(np.tile(sec[:, None],
                                                        (1, C)))


def _complex_pairs(K):
    """The I and Q rows of each complex quantity: the taps, the coherent
    accumulators, the previous prompt, the half-window prompt, and the
    CN0 window's I and Q power sums.  Over a 16-epoch chunk the
    frozen-vs-true phase ledger carries ~1e-5 rad of float32 rounding that
    differs between the implementations, so a rotated tap differs by
    ~1e-5 of its magnitude in I and Q alike, and the smaller component of
    an accumulator (or of its power) can miss 1e-4 of its own row's
    maximum while both hold 1e-4 of the complex value's scale."""
    acc = tuple((tc.F_ACC_R0 + k, tc.F_ACC_R0 + K + k) for k in range(K))
    return {"out_corr": tuple((k, K + k) for k in range(K)),
            "fst": acc + ((tc.F_PREV_R, tc.F_PREV_I),
                          (tc.F_ACCH_R, tc.F_ACCH_I),
                          (tc.F_SI2, tc.F_SQ2))}


def _sec_chunk(spec, fst, ist, sec, rng):
    """One chunk's lag windows around the correlation peak whose sign
    follows each channel's secondary chip epoch by epoch (the code phase
    the state carries), in the Pallas layout."""
    E16, n = spec.E, spec.sec_len
    start = ist[tc.I_START].astype(np.int64)
    s_reg = (start[None, :] - (E16 + 4)
             + np.arange(E16)[:, None] * spec.t0_int).astype(np.int32)
    lag = np.arange(spec.LW)[None, :, None]
    pk = (spec.lag_margin + (E16 + 4) + fst[tc.F_REM_CODE])[None, None, :]
    tri = np.maximum(0.0, 1.0 - np.abs(lag - pk) / spec.spc_samples)
    chip = sec[(ist[tc.I_SEC_IDX][None, :] + np.arange(E16)[:, None]) % n, 0]
    amp = (rng.normal(size=(E16, 1, C)) * 20.0 + 300.0) * chip[:, None, :]
    ph = rng.uniform(-0.3, 0.3, size=(E16, 1, C))
    zr = (amp * np.cos(ph) * tri
          + rng.normal(size=(E16, spec.LW, C)) * 10.0).astype(np.float32)
    zi = (amp * np.sin(ph) * tri
          + rng.normal(size=(E16, spec.LW, C)) * 10.0).astype(np.float32)
    step0 = (2 * np.pi * (fst[tc.F_DOPPLER] + 0.7) / spec.fs)[None].astype(
        np.float32)
    return zr, zi, s_reg, step0


@pytest.mark.parametrize("name", SEC_CODES)
def test_chain_secondary_code_over_chunks_matches_pallas_interpret(
        jax_chain, tracked_state, name):
    """The wipe's index clamp and its advance modulo the code length
    (pallas_chain.py:230, :460) across chunk seams: each implementation
    carries its own state from chunk to chunk, and every chunk's outputs
    and state agree."""
    import jax.numpy as jnp

    spec, fst, ist, sec = _sec_setup(tracked_state, name)
    n = spec.sec_len
    call = jax_chain.make_chain_call(
        jax_chain.ChainSpec(**dataclasses.asdict(spec)), interpret=True)
    rng = np.random.default_rng(n)
    fj, ij, ft, it = fst, ist, torch.from_numpy(fst), torch.from_numpy(ist)
    pushes = ist[tc.I_PUSH].copy()
    for k in range(SEC_CHUNKS):
        zr, zi, s_reg, step0 = _sec_chunk(spec, fj, ij, sec, rng)
        want = call(*(jnp.asarray(a) for a in (zr, zi, s_reg, step0, sec,
                                               fj, ij)))
        got = tc.chain(spec, *_port_args((zr, zi, s_reg, step0, sec,
                                          ft.numpy(), it.numpy())))
        _compare(got, want, f"{name} chunk {k}", _complex_pairs(spec.K))
        n_valid = np.asarray(got[0])[:, tc.O_VALID].sum(axis=0).astype(int)
        assert (n_valid == spec.E).all()
        # the index advanced once per epoch, modulo the code length; the
        # channel without the wipe keeps advancing it too
        np.testing.assert_array_equal(np.asarray(got[4])[tc.I_SEC_IDX],
                                      (ij[tc.I_SEC_IDX] + spec.E) % n)
        fj, ij = np.asarray(want[3]), np.asarray(want[4])
        ft, it = got[3], got[4]
    # the extended channels closed their windows on the code's grid: one
    # loop update per n epochs (ch0 first after 2 epochs)
    done = np.asarray(it)[tc.I_PUSH] - pushes
    assert done[0] == 1 + (SEC_CHUNKS * spec.E - 2) // n
    assert done[1] == (SEC_CHUNKS * spec.E + 4) // n
    assert done[2] == done[3] == SEC_CHUNKS * spec.E


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
def test_chain_kernel_matches_plain_on_gpu(request, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA chain kernel has no CPU "
                    "mode)")
    spec, args = _case(_state(request, "port_state", CASES[case]),
                       CASES[case], seed=len(case))
    port = _port_args(args)
    dev = [t.cuda() for t in port]
    before = tc.launches
    got = tc.chain(spec, *dev)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    # the plain version on the CPU divides as the kernel does (on CUDA
    # tensors torch divides by a Python scalar as a multiply by the
    # reciprocal)
    want = tc.chain_plain(spec, *port)
    _compare([t.cpu() for t in got], want, case)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SEC_CODES)
def test_chain_secondary_code_over_chunks_kernel_matches_plain_on_gpu(
        port_state, name):
    """The kernel's `<3, 3, true, true>` instance against the plain version
    on the CPU over consecutive chunks, each carrying its own state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA chain kernel has no CPU "
                    "mode)")
    spec, fst, ist, sec = _sec_setup(port_state, name)
    rng = np.random.default_rng(spec.sec_len)
    fp, ip, fk, ik = fst, ist, fst, ist
    for k in range(SEC_CHUNKS):
        zr, zi, s_reg, step0 = _sec_chunk(spec, fp, ip, sec, rng)
        want = tc.chain_plain(spec, *_port_args((zr, zi, s_reg, step0, sec,
                                                 fp, ip)))
        before = tc.launches
        got = tc.chain(spec, *(t.cuda() for t in _port_args(
            (zr, zi, s_reg, step0, sec, fk, ik))))
        torch.cuda.synchronize()
        assert tc.launches == before + 1
        _compare([t.cpu() for t in got], want, f"{name} chunk {k}",
                 _complex_pairs(spec.K))
        fp, ip = want[3].numpy(), want[4].numpy()
        fk, ik = got[3].cpu().numpy(), got[4].cpu().numpy()
