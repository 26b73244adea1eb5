"""GLONASS L1/L2 C/A with FDMA in the port against the JAX package, on the
CPU (numpy inputs made from seeds; the JAX engine with
`correlator='mxu'`, the Pallas chain in interpret mode).

- Codes, carrier offsets, constants and the RK4 orbit: bit for bit.
- FDMA PCPS on a 60 ms capture of three slots with odd and even k (the
  odd ones force the two-period window): the same detections, the same
  Doppler bin, delays within 1 sample, statistics to rtol 1e-4.
- The chunk correlator's window and wipe with a non-zero carrier bias
  (`F_CARR_OFF`) against the JAX window/einsum: slice origins and step0
  exact, lag windows at atol 1e-4 of max|z|; at 6.625 Msps with |k| = 5
  (2.81 MHz, the largest offset that rate's +-3.31 MHz band holds).
- The chain with a non-zero `F_CARR_OFF` over three consecutive chunks
  against the interpret-mode Pallas chain: int rows exact, float rows at
  1e-4 of each row's scale.
- One engine capture with non-zero `carr_offset_hz` at the engine bars
  of ROADMAP.md (valid, start and cur_len exact; Doppler, code delta and
  rem code at atol 2e-2).
- The GNAV channel decoder on one noisy symbol stream: the same string
  sync, ephemeris and time of day.
- The receiver's FDMA wiring (offsets into acquisition and the channel's
  NCO bias, the GNAV decoders).

The slow case is the port's twin of tests/test_system_glonass.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnss_sdr_1_tpu.codes as jcodes
import gnss_sdr_1_tpu.constants as jconst
import gnss_sdr_1_tpu.siggen.scenario as jscen
import gnss_sdr_1_tpu_torch.codes as tcodes
import gnss_sdr_1_tpu_torch.constants as tconst
import gnss_sdr_1_tpu_torch.siggen.scenario as tscen
from gnss_sdr_1_tpu.siggen import SatParams
from gnss_sdr_1_tpu.siggen.generator import generate_baseband as jgen
from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
from gnss_sdr_1_tpu.utils.planar import to_planar
from gnss_sdr_1_tpu_torch.ops import chunk_corr as cc
from gnss_sdr_1_tpu_torch.ops import track_chain as tc
from gnss_sdr_1_tpu_torch.pvt.geodesy import llh_to_ecef
from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy, state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RX = llh_to_ecef(np.radians(55.75), np.radians(37.62), 180.0)
T0 = 35995.0               # 25 s into a 30 s GNAV frame
FS = 4.092e6
# the acquisition capture's slots: odd and even frequency channels
ACQ_KS = {1: -3, 2: 0, 4: 2}
# the engine checks' slots at 6.625 Msps: |k| = 5 is 2.81 MHz
FS_HI = 6.625e6
ENG_KS = (-5, 2, 5)
F16_RTOL = 2.0 ** -10


# ---------------------------------------------------------------------------
# codes, offsets, constants, orbits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sid", ["1G", "2G"])
def test_codes_offsets_and_constants_identical(sid):
    np.testing.assert_array_equal(tcodes.glonass_ca_code(),
                                  jcodes.glonass_ca_code())
    for slot in (1, 9, 24):
        rj = jcodes.tracking_replica(sid, slot)
        rt = tcodes.tracking_replica(sid, slot)
        np.testing.assert_array_equal(rt[0], rj[0])
        assert rt[1:] == rj[1:] == (0.511e6, 1)
    for k in range(-7, 7):
        assert tconst.glonass_fdma_offset_hz(sid, k) == \
            jconst.glonass_fdma_offset_hz(sid, k)
    assert tconst.glonass_fdma_offset_hz("1C", 3) == 0.0
    assert dataclasses.asdict(tconst.SIGNALS[sid]) == \
        dataclasses.asdict(jconst.SIGNALS[sid])
    for name in ("FREQ_G1_GLO", "DFRQ1_GLO", "FREQ_G2_GLO", "DFRQ2_GLO"):
        assert getattr(tconst, name) == getattr(jconst, name)


def test_glonass_orbit_and_clock_identical():
    """The RK4 state-vector propagation and the clock model, directly and
    through the solver's ephemeris dispatch."""
    import gnss_sdr_1_tpu.pvt.solver as jsolver
    import gnss_sdr_1_tpu_torch.pvt.solver as tsolver

    sj = jscen.build_scenario(RX, [3], t0_tow=T0, duration_s=10.0,
                              chip_rate=0.511e6, signal="1G")
    st = tscen.build_scenario(RX, [3], t0_tow=T0, duration_s=10.0,
                              chip_rate=0.511e6, signal="1G")
    ej, et = sj.ephemerides[3], st.ephemerides[3]
    assert dataclasses.asdict(et) == dataclasses.asdict(ej)
    for t in (T0, T0 + 4.5, ej.tb_s - 1234.5, ej.tb_s + 900.0):
        pj, vj = jsolver.sat_pos_vel(ej, t)
        pt, vt = tsolver.sat_pos_vel(et, t)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(vt, vj)
        assert tsolver.sat_clock(et, t) == jsolver.sat_clock(ej, t)


# ---------------------------------------------------------------------------
# FDMA acquisition
# ---------------------------------------------------------------------------


def _acq_capture():
    scen = jscen.build_scenario(RX, sorted(ACQ_KS), t0_tow=T0,
                                duration_s=0.06, cn0_dbhz=47.0,
                                chip_rate=0.511e6, signal="1G",
                                fdma_ks=ACQ_KS)
    code = jcodes.glonass_ca_code()
    x = jgen(jconst.GLONASS_L1_CA, scen.sats,
             {p: code for p in ACQ_KS}, FS, 0.06, noise=True, seed=8)
    return scen, x


def _glo_cfg(mod, ks, fs=FS, **kw):
    from gnss_sdr_1_tpu.runtime.receiver import ReceiverConfig as JCfg

    cls = JCfg if mod == "jax" else ReceiverConfig
    return cls(fs_hz=fs, signal_id="1G", n_channels=len(ks),
               prn_search=tuple(sorted(ks)), fdma_k=tuple(sorted(ks.items())),
               **{"acq_dwells": 3, **kw})


def test_fdma_pcps_matches_jax():
    from gnss_sdr_1_tpu.runtime.receiver import Receiver as JReceiver

    scen, x = _acq_capture()
    aj = JReceiver(_glo_cfg("jax", ACQ_KS)).acq
    at = Receiver(_glo_cfg("port", ACQ_KS), device="cpu").acq
    # k = -3 is 1687.5 cycles per 1 ms window: the two-period window
    assert at.cfg.bit_transition_flag and aj.cfg.bit_transition_flag
    assert at.freq_offsets == aj.freq_offsets == {
        p: 562.5e3 * k for p, k in ACQ_KS.items()}
    head = x[: at.cfg.fft_size * 3]
    rj, rt = aj.acquire(head), at.acquire(head)
    np.testing.assert_array_equal(rt.positive, rj.positive)
    assert rt.positive.all()
    np.testing.assert_array_equal(rt.doppler_hz, rj.doppler_hz)
    spc = at.cfg.samples_per_code
    dd = np.abs(rt.delay_samples - rj.delay_samples) % spc
    assert (np.minimum(dd, spc - dd) <= 1.0).all()
    np.testing.assert_allclose(rt.test_stat, rj.test_stat, rtol=1e-4)
    # each slot found its own satellite at the residual Doppler of its
    # band (within two fine bins of the truth)
    for k, p in enumerate(at.prns):
        assert abs(rt.doppler_hz[k] - scen.truth[p]["doppler_hz"]) <= 80.0


def test_even_offsets_keep_the_one_period_window():
    """Whole-cycle offsets (even k: k * 562.5 cycles per ms) need no
    two-period window; a GLONASS symbol spans ten code periods."""
    ks = {1: -2, 2: 0, 3: 4}
    at = Receiver(_glo_cfg("port", ks), device="cpu").acq
    assert not at.cfg.bit_transition_flag
    assert at.cfg.fft_size == at.cfg.samples_per_code


# ---------------------------------------------------------------------------
# the engine with a non-zero carrier bias
# ---------------------------------------------------------------------------


def _engine_capture(ks=ENG_KS):
    """Three GLONASS slots at 6.625 Msps on the FDMA carriers of `ks`,
    100 sps meander symbols, 0.26 s."""
    rng = np.random.default_rng(23)
    sats = [SatParams(prn=ch + 1, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, 511)), cn0_dbhz=50.0,
                      nav_bits=rng.choice([-1.0, 1.0], 40),
                      carrier_offset_hz=562.5e3 * k,
                      bit_rate_override_bps=100.0)
            for ch, k in enumerate(ks)]
    code = jcodes.glonass_ca_code()
    x = jgen(jconst.GLONASS_L1_CA, sats, {s.prn: code for s in sats}, FS_HI,
             0.26, noise=True, seed=6)
    return sats, np.stack([code] * 3), x


_KW = dict(fs_hz=FS_HI, code_length_chips=511, chip_rate_chips_s=0.511e6,
           carrier_freq_hz=jconst.FREQ_G1_GLO, n_channels=3, pll_bw_hz=25.0,
           dll_bw_hz=2.0)
# the frequency channels of the engine checks: all at k = 0 (the standard
# bars) and on their FDMA carriers (the bars of the float32 ledger)
BIAS = {"k0": (0, 0, 0), "fdma": ENG_KS}


def _activate(eng, sats, **kw):
    st = eng.init_state()
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / 0.511e6 * FS_HI,
                                  s.doppler_hz, 0, 0,
                                  carr_offset_hz=s.carrier_offset_hz)
    return st


@pytest.fixture(scope="module")
def engines():
    codes = np.stack([jcodes.glonass_ca_code()] * 3)
    ej = JEngine(JTrackConfig(correlator="mxu", **_KW), codes)
    et = TrackingEngine(TrackConfig(**_KW), codes, device="cpu")
    return ej, et


@pytest.fixture(scope="module")
def captures():
    return {name: _engine_capture(ks) for name, ks in BIAS.items()}


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


def test_activation_carries_the_bias_like_jax(engines, captures):
    ej, et = engines
    sats = captures["fdma"][0]
    lt = state_to_numpy(_activate(et, sats))
    lj = _leaves(_activate(ej, sats))
    assert set(lt) == set(lj)
    for name, v in lj.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        lt[name] if isinstance(v, tuple) else (lt[name],)):
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(
        lt["carr_offset_hz"], np.float32([562.5e3 * k for k in ENG_KS]))


@pytest.mark.parametrize("tracked", [False, True],
                         ids=["activated", "mid_track"])
def test_chunk_corr_with_carrier_bias_matches_jax_windows_einsum(
        engines, captures, tracked):
    ej, et = engines
    sats, codes, x = captures["fdma"]
    st = _activate(ej, sats)
    if tracked:
        head = int(FS_HI * 0.02)
        st, _ = ej.track_capture(jnp.asarray(to_planar(x)), st, head)
        x = x[head:]
    samples_p = ej._pad_for_chunks(jnp.asarray(to_planar(x)))
    wiped, s_reg_j, _, _, step0_j = ej._chunk_windows(samples_p, st)
    rep = ej._rep_rows[st.prn_slot]
    zr_j = np.asarray(jnp.einsum("cen,cln->cel", wiped.real, rep,
                                 preferred_element_type=jnp.float32))
    zi_j = np.asarray(jnp.einsum("cen,cln->cel", wiped.imag, rep,
                                 preferred_element_type=jnp.float32))
    tst = state_from_numpy(_leaves(st), "cpu")
    fst, ist = et._pack_rows(tst, 10 ** 6)
    np.testing.assert_array_equal(
        fst[tc.F_CARR_OFF].numpy(), np.float32([562.5e3 * k
                                                 for k in ENG_KS]))
    samples = et._pad_for_chunks(torch.from_numpy(x))
    zr, zi, s_reg, step0 = cc.chunk_corr(et.corr_spec, samples, et._rows,
                                         tst.prn_slot.to(torch.int32), fst,
                                         ist)
    np.testing.assert_array_equal(s_reg.numpy(), np.asarray(s_reg_j))
    np.testing.assert_array_equal(step0.numpy(), np.asarray(step0_j))
    # step0 carries the bias: |k| = 5 is ~2.67 rad per sample
    assert np.abs(step0.numpy()).max() > 2.6
    scale = max(np.abs(zr_j).max(), np.abs(zi_j).max())
    assert scale > 100.0
    np.testing.assert_allclose(zr.numpy(), zr_j, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(zi.numpy(), zi_j, rtol=0, atol=1e-4 * scale)


def _complex_pairs(K):
    """The I and Q rows of each complex quantity (taps, coherent
    accumulators, previous and half-window prompts, the CN0 window's I and
    Q power sums)."""
    acc = tuple((tc.F_ACC_R0 + k, tc.F_ACC_R0 + K + k) for k in range(K))
    return {"out_corr": tuple((k, K + k) for k in range(K)),
            "fst": acc + ((tc.F_PREV_R, tc.F_PREV_I),
                          (tc.F_ACCH_R, tc.F_ACCH_I),
                          (tc.F_SI2, tc.F_SQ2))}


def _ledger_ulp(spec, fst):
    """The float32 rounding unit of the chain's largest carrier-ledger
    term, step * len = 2 pi |doppler + carr_off| (t0_int + 1) / fs."""
    m = 2.0 * np.pi * float(np.abs(fst[tc.F_DOPPLER]
                                   + fst[tc.F_CARR_OFF]).max()) \
        * (spec.t0_int + 1) / spec.fs
    return float(np.spacing(np.float32(m)))


def _compare(got, want, what, delta=0.0, pairs=None):
    """Int rows and flags exact; each float row within 1e-4 of its scale
    plus `delta` (radians) times its scale (a complex quantity's I and Q
    rows: their common scale); the carrier-phase rows compared modulo
    2 pi."""
    names = ("out_f", "out_i", "out_corr", "fst", "ist")
    phase_rows = {"out_f": (tc.O_REM_CARR,), "fst": (tc.F_REM_CARR,)}
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        if name in ("out_i", "ist"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        partner = {}
        for a, b in (pairs or {}).get(name, ()):
            partner[a], partner[b] = b, a
        for r in range(g.shape[-2]):
            gr, wr = g[..., r, :], w[..., r, :]
            if name == "out_f" and r in (tc.O_VALID, tc.O_ACTIVE):
                np.testing.assert_array_equal(gr, wr, err_msg=f"{what} {r}")
                continue
            scale = max(1.0, float(np.abs(wr).max()))
            if r in partner:
                scale = max(scale, float(np.abs(w[..., partner[r], :]).max()))
            d = gr - wr
            if r in phase_rows.get(name, ()):
                d = np.mod(d + np.pi, 2.0 * np.pi) - np.pi
            assert np.abs(d).max() <= (1e-4 + delta) * scale, \
                (what, name, r, float(np.abs(d).max()), scale)


def _chain_inputs(spec, fst, ist, rng):
    """One chunk's lag windows around the correlation peak (Pallas
    layout) and the chunk-entry step0 of the frozen NCO."""
    E, C, LW = spec.E, spec.C, spec.LW
    start = ist[tc.I_START].astype(np.int64)
    s_reg = (start[None, :] - (E + 4)
             + np.arange(E)[:, None] * spec.t0_int).astype(np.int32)
    lag = np.arange(LW)[None, :, None]
    pk = (spec.lag_margin + (E + 4) + fst[tc.F_REM_CODE])[None, None, :]
    tri = np.maximum(0.0, 1.0 - np.abs(lag - pk) / spec.spc_samples)
    amp = rng.normal(size=(E, 1, C)) * 20.0 + 300.0
    ph = rng.uniform(-0.3, 0.3, size=(E, 1, C))
    zr = (amp * np.cos(ph) * tri
          + rng.normal(size=(E, LW, C)) * 10.0).astype(np.float32)
    zi = (amp * np.sin(ph) * tri
          + rng.normal(size=(E, LW, C)) * 10.0).astype(np.float32)
    step0 = (2 * np.pi * (fst[tc.F_DOPPLER] + fst[tc.F_CARR_OFF] + 0.7)
             / spec.fs)[None].astype(np.float32)
    return zr, zi, s_reg, step0


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("bias", sorted(BIAS))
def test_chain_with_carrier_bias_matches_pallas_interpret(engines, captures,
                                                          bias, mode):
    """The chain's rows after 20 ms of JAX tracking of three GLONASS slots,
    over three chunks of lag windows around the correlation peak.

    k0: every slot at k = 0; each implementation carries its own state
    from chunk to chunk, held at 1e-4 of each row's scale (a complex
    quantity's I and Q rows at their common scale, as the secondary-code
    cases of tests/test_torch_chain.py hold them).  fdma: the slots
    at k = -5, 2, 5 (2.81 MHz at 6.625 Msps).  The biased steps
    (step_true, carr_step_new, step_new) then put ~17,700 rad into the
    float32 carrier ledger each epoch, whose rounding unit is ~2e-3 rad;
    XLA on the CPU rounds the Pallas chain's steps otherwise than
    operation-by-operation IEEE arithmetic (the port's plain chain and its
    CUDA kernel, built with --fmad=false), so each chunk starts both from
    the JAX state and every float row is held within 1e-4 of its scale plus
    two ledger rounding units per epoch (phase rows modulo 2 pi, complex
    quantities at their I/Q common scale)."""
    from gnss_sdr_1_tpu.ops import pallas_chain

    ej, et = engines
    sats, codes, x = captures[bias]
    st, _ = ej.track_capture(jnp.asarray(to_planar(x)), _activate(ej, sats),
                             int(FS_HI * 0.02))
    fst, ist = et._pack_rows(state_from_numpy(_leaves(st), "cpu"), 10 ** 6)
    fst, ist = fst.numpy(), ist.numpy()
    spec = et.chain_spec
    if mode == "narrow":
        spec = dataclasses.replace(spec, ext_n=4)
        ist[tc.I_MODE] = 1
        ist[tc.I_EXTCNT] = (1, 2, 3)
    np.testing.assert_array_equal(
        fst[tc.F_CARR_OFF], np.float32([562.5e3 * k for k in BIAS[bias]]))
    call = pallas_chain.make_chain_call(
        pallas_chain.ChainSpec(**dataclasses.asdict(spec)), interpret=True)
    sec = np.ones((1, spec.C), np.float32)
    rng = np.random.default_rng(12)
    delta = 0.0
    if bias == "fdma":
        delta = 2 * spec.E * _ledger_ulp(spec, fst)
        assert 0.05 < delta < 0.07      # 2 x 16 x 2^-9 rad at |k| = 5
    fj, ij, ft, it = fst, ist, fst, ist
    for k in range(3):
        zr, zi, s_reg, step0 = _chain_inputs(spec, fj, ij, rng)
        want = call(*(jnp.asarray(a) for a in (zr, zi, s_reg, step0, sec, fj,
                                               ij)))
        if bias == "fdma":
            ft, it = fj, ij
        port = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            zr.transpose(2, 0, 1), zi.transpose(2, 0, 1), s_reg.T, step0[0],
            sec, ft, it))
        got = tc.chain(spec, *port)
        _compare(got, want, f"{bias} {mode} chunk {k}", delta,
                 _complex_pairs(spec.K))
        assert np.asarray(got[0])[:, tc.O_VALID].all()
        fj, ij = np.asarray(want[3]), np.asarray(want[4])
        ft, it = got[3].numpy(), got[4].numpy()
    np.testing.assert_array_equal(ft[tc.F_CARR_OFF], fst[tc.F_CARR_OFF])


@pytest.mark.parametrize("bias", sorted(BIAS))
def test_engine_with_carrier_bias_matches_jax(engines, captures, bias):
    """Three channels activated at the truth by both engines and tracked
    0.2 s from the same state.  k0: the one-capture engine bars of
    ROADMAP.md (valid, start and cur_len exact; Doppler, code delta and
    rem code at atol 2e-2).  fdma (k = -5, 2, 5): the epoch grid and the
    code loop at the same bars; the carrier loop, whose discriminator
    reads the float32 ledger (see the chain case), at ROADMAP.md's
    long-track bars (Doppler within 1 Hz, CN0 mean |diff| under 0.7 dB)."""
    ej, et = engines
    sats, codes, x = captures[bias]
    leaves = state_to_numpy(_activate(et, sats))
    span = int(FS_HI * 0.2)
    st_j, oj = ej.track_capture(jnp.asarray(to_planar(x)),
                                _state_from_jax(leaves), span)
    st_t, ot = et.track_capture(torch.from_numpy(x),
                                state_from_numpy(leaves, "cpu"), span)
    np.testing.assert_array_equal(ot.valid, oj.valid)
    v = oj.valid
    assert v.sum() >= 0.95 * 200 * 3
    np.testing.assert_array_equal(ot.start[v], oj.start[v])
    np.testing.assert_array_equal(ot.cur_len[v], oj.cur_len[v])
    np.testing.assert_array_equal(ot.active, oj.active)
    assert ot.active[-1].all()
    dop_atol = 2e-2 if bias == "k0" else 1.0
    np.testing.assert_allclose(ot.carrier_doppler_hz[v],
                               oj.carrier_doppler_hz[v], rtol=0,
                               atol=dop_atol)
    np.testing.assert_allclose(ot.rem_code_phase_samples[v],
                               oj.rem_code_phase_samples[v], rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(ot.code_freq_delta[v], oj.code_freq_delta[v],
                               rtol=F16_RTOL, atol=2e-2)
    assert np.abs(ot.cn0_dbhz[v] - oj.cn0_dbhz[v]).mean() < 0.7
    sj, stn = _leaves(st_j), state_to_numpy(st_t)
    for name in ("start", "cur_len", "push_count", "active"):
        np.testing.assert_array_equal(stn[name], sj[name], err_msg=name)
    np.testing.assert_allclose(stn["carrier_doppler_hz"],
                               sj["carrier_doppler_hz"], rtol=0,
                               atol=dop_atol)
    for name in ("code_freq_delta", "rem_code_phase_samples"):
        np.testing.assert_allclose(stn[name], sj[name], rtol=0, atol=2e-2,
                                   err_msg=name)
    # the loop holds each slot's Doppler on its own FDMA carrier
    for ch, s in enumerate(sats):
        assert abs(stn["carrier_doppler_hz"][ch] - s.doppler_hz) < 10.0


# ---------------------------------------------------------------------------
# the GNAV channel decoder and the receiver wiring
# ---------------------------------------------------------------------------


def test_glonass_channel_decoder_identical():
    """Both GNAV channel decoders fed the same noisy 1 ms prompts of a
    scenario's meander symbols (starting 3 ms into a symbol) agree on the
    10 ms phase, the ephemeris and the time of day, and decode the
    broadcast state vector."""
    import gnss_sdr_1_tpu.telemetry.channel_adapters as jadapt
    import gnss_sdr_1_tpu_torch.telemetry.channel_adapters as tadapt

    scen = jscen.build_scenario(RX, [4], t0_tow=T0, duration_s=16.0,
                                chip_rate=0.511e6, signal="1G",
                                fdma_ks={4: 1})
    syms = np.asarray(scen.sats[0].nav_bits)
    rng = np.random.default_rng(5)
    prompts = (np.repeat(syms, 10) * 60.0
               + rng.normal(size=10 * len(syms)) * 15.0)[3:]
    dj, dt = jadapt.GlonassChannelDecoder(4), tadapt.GlonassChannelDecoder(4)
    for k in range(0, len(prompts), 997):
        dj.push(prompts[k:k + 997])
        dt.push(prompts[k:k + 997])
    assert dt.ephemeris_complete and dj.ephemeris_complete
    assert dt._phase0 == dj._phase0
    assert dataclasses.asdict(dt.ephemeris) == dataclasses.asdict(
        dj.ephemeris)
    for s in (0, 7000, len(prompts) - 1):
        assert dt.tow_at_symbol(s) == dj.tow_at_symbol(s)
    truth = scen.ephemerides[4]
    assert dt.ephemeris.x_km == pytest.approx(truth.x_km, abs=1e-9)
    assert dt.ephemeris.tb_s == truth.tb_s


def test_receiver_wires_fdma_into_acquisition_and_tracking():
    """The port's Receiver over the 60 ms three-slot capture: each slot's
    offset reaches its acquisition replica and its channel's NCO bias, the
    decoders are GNAV channel decoders, and no secondary wipe is set."""
    from gnss_sdr_1_tpu_torch.telemetry.channel_adapters import \
        GlonassChannelDecoder

    scen, x = _acq_capture()
    rx = Receiver(_glo_cfg("port", ACQ_KS, acq_dwells=2), device="cpu")
    spec = rx.trk.chain_spec
    assert (spec.K, spec.sec_len, spec.sec_data) == (3, 1, False)
    assert rx._sec_period is None
    rx.process(x)
    assert sorted(p for p in rx.channel_prn if p) == sorted(ACQ_KS)
    offs = rx.state.carr_offset_hz.numpy()
    for ch, p in enumerate(rx.channel_prn):
        assert offs[ch] == np.float32(562.5e3 * ACQ_KS[p])
        assert isinstance(rx.decoders[p], GlonassChannelDecoder)
    assert min(rx.sym_count.values()) > 0


# ---------------------------------------------------------------------------
# the system scenario (tests/test_system_glonass.py), slow
# ---------------------------------------------------------------------------

SYS_KS = {1: -2, 2: -1, 3: 0, 4: 1, 5: 2}


@pytest.mark.slow
def test_glonass_system_scenario():
    """tests/test_system_glonass.py's run on the port, on the CPU: 5 slots
    with k in {-2..2}, 20 s at 4.092 Msps, 47 dB-Hz, at its bars (>= 4
    slots tracked > 10,000 epochs, >= 4 GNAV ephemerides equal to the
    broadcast truth, >= 10 fixes, median 3D < 15 m)."""
    from test_torch_capture_cache import cached_capture

    slots = sorted(SYS_KS)
    scen = jscen.build_scenario(RX, slots, t0_tow=T0, duration_s=20.0,
                                cn0_dbhz=47.0, chip_rate=0.511e6,
                                carrier_freq=jconst.FREQ_G1_GLO, signal="1G",
                                fdma_ks=SYS_KS)
    code = jcodes.glonass_ca_code()
    x = cached_capture(
        f"sysglo_{FS:.0f}_20_v2",
        lambda: jgen(jconst.GLONASS_L1_CA, scen.sats,
                     {p: code for p in slots}, FS, 20.0, noise=True))
    rx = Receiver(ReceiverConfig(
        fs_hz=FS, signal_id="1G", n_channels=5, prn_search=tuple(slots),
        fdma_k=tuple(SYS_KS.items()), acq_dwells=3, pll_bw_hz=25.0,
        dll_bw_hz=2.0), device="cpu")
    sols = rx.process(x)
    tracked = {p: n for p, n in rx.sym_count.items() if n > 10_000}
    assert len(tracked) >= 4, rx.sym_count
    complete = [(s, d) for s, d in rx.decoders.items()
                if d.ephemeris_complete]
    assert len(complete) >= 4
    for slot, dec in complete:
        g, t = dec.ephemeris, scen.ephemerides[slot]
        assert g.x_km == pytest.approx(t.x_km, abs=1e-9)
        assert g.vz_kms == pytest.approx(t.vz_kms, abs=1e-12)
        assert g.tb_s == t.tb_s
    assert len(sols) >= 10
    errs = np.array([np.linalg.norm(s.rx_ecef_m - scen.rx_ecef)
                     for s in sols])
    assert float(np.median(errs)) < 15.0
