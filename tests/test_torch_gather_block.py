"""The port's per-epoch gather DLL/PLL path (ops/gather_block.py, the
engine's `correlator='gather'`) against the JAX package's gather engine
(`TrackingEngine(correlator='gather')`, the exact path it runs off the TPU),
on the CPU.

- `gather_block_plain` through the port's engine against the JAX engine's
  `_track_capture_impl` over ~60 ms of 4 channels, for GPS L1 C/A, Galileo
  E1B (VEML), GPS L5 (NH10 wipe on), Galileo E5a (CS20), BeiDou B1I (NH20,
  `sec_data`), GLONASS L1 at k = +-1 (FDMA) and GPS L2CM; both engines
  start from the same state (tracked by the port over a short head, the
  secondary-code signals then switched to the extended, wiped mode by
  both).  Bars (ROADMAP.md, "Engine, one capture"): valid, start and
  cur_len exact; Doppler, rem code and rem carrier at atol 2e-2 (the
  rem carrier circular); the fields the JAX package ships as f16 at f16
  resolution; the final int state exact.
- `track_capture_symbols` against JAX's.
- `gather_geometry` at every shape of chip_smoke.py's phase 2c, and the
  kernel source's constants.
- The wrapper: plain on CPU tensors, no launch counted; the kernel against
  the plain walk on the card (gpu-marked, skips without a card;
  `python -m pytest --noconftest -m gpu tests/test_torch_gather_block.py`
  on the GPU machine imports nothing of JAX).
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import NH10, NH20, tracking_replica
from gnss_sdr_1_tpu_torch.codes.galileo_e5 import galileo_e5ai_secondary
from gnss_sdr_1_tpu_torch.constants import SIGNALS
from gnss_sdr_1_tpu_torch.ops import cluster_walk as cw
from gnss_sdr_1_tpu_torch.ops import gather_block as gb
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy, state_to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F16_RTOL = 2.0 ** -10        # one f16 ulp, relative
N_CH = 4
# signal -> (fs, engine keywords beyond the signal's own, secondary code,
# head tracked before the comparison [s], compared span [s], FDMA k)
CASES = {
    "1C": (4.092e6, {}, None, 0.03, 0.06, None),
    "1B": (4.0e6, dict(veml=True, early_late_space_chips=0.15,
                       very_early_late_space_chips=0.6), None, 0.04, 0.06,
           None),
    "L5": (12.0e6, dict(pll_bw_hz=18.0, sec_data=True), NH10, 0.029, 0.06,
           None),
    "5X": (12.0e6, dict(pll_bw_hz=18.0, sec_data=True),
           galileo_e5ai_secondary(), 0.029, 0.06, None),
    "B1": (4.0e6, dict(pll_bw_hz=18.0, sec_data=True,
                       early_late_space_chips=0.2), NH20, 0.029, 0.06, None),
    "1G": (4.092e6, {}, None, 0.03, 0.06, (-1, 1, -1, 1)),
    "2S": (2.046e6, dict(pll_bw_hz=4.0, dll_bw_hz=0.4), None, 0.06, 0.1,
           None),
}


def _config(signal, correlator="gather", n_ch=N_CH):
    """TrackConfig keywords of `signal`'s engine as the receivers build it
    (the replica's samples per chip; the JAX package's keyword names)."""
    fs, extra, sec, _, _, _ = CASES[signal]
    spec = SIGNALS[signal]
    _, rate, spc = tracking_replica(signal, 1 if signal != "B1" else 6)
    kw = dict(fs_hz=fs, code_length_chips=spec.code_length_chips,
              chip_rate_chips_s=spec.code_rate_chips_s,
              carrier_freq_hz=spec.carrier_freq_hz, n_channels=n_ch,
              code_samples_per_chip=spc, correlator=correlator, **extra)
    if sec is not None:
        kw["extend_correlation_symbols"] = len(sec)
    return kw


def _capture(signal, duration):
    """N_CH satellites of `signal` (seeded), their replica rows and a noisy
    capture made by the port's generator (the JAX package's byte for byte,
    tests/test_torch_host_copies.py); secondary-coded signals carry their
    code times the data as one 1 kbps stream, so epoch k of a channel
    activated at the truth carries secondary chip k mod its length."""
    fs, _, sec, _, _, ks = CASES[signal]
    spec = SIGNALS[signal]
    prns = [6, 7, 8, 9] if signal == "B1" else [1, 2, 3, 4]
    reps = {p: tracking_replica(signal, p) for p in prns}
    _, rate, spc = reps[prns[0]]
    n_chips = spec.code_length_chips * spc
    rng = np.random.default_rng(31)
    gen_spec = dataclasses.replace(spec, code_rate_chips_s=rate,
                                   code_length_chips=n_chips)
    sats = []
    for k, p in enumerate(prns):
        kw = dict(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                  delay_chips=float(rng.uniform(0, n_chips)), cn0_dbhz=47.0)
        if sec is not None:
            n_sym = int(duration * 1000) // len(sec) + 2
            kw.update(nav_bits=np.repeat(rng.choice([-1.0, 1.0], n_sym),
                                         len(sec)) * np.tile(
                np.asarray(sec, np.float64), n_sym),
                bit_rate_override_bps=1000.0)
        if ks is not None:
            kw["carrier_offset_hz"] = 562.5e3 * ks[k]
        sats.append(SatParams(**kw))
    codes = np.stack([reps[p][0] for p in prns])
    x = generate_baseband(gen_spec, sats, {p: reps[p][0] for p in prns}, fs,
                          duration, noise=True, seed=7)
    sec_codes = (None if sec is None else
                 np.tile(np.asarray(sec, np.float32), (N_CH, 1)))
    return sats, codes, sec_codes, x.astype(np.complex64), rate


def _activate(eng, sats, rate):
    st = eng.init_state()
    fs = eng.cfg.fs_hz
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / rate * fs,
                                  s.doppler_hz, 0, 0,
                                  carr_offset_hz=s.carrier_offset_hz)
    return st


def _leaves(st):
    return {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in st._asdict().items()}


def _state_from_jax(leaves):
    import jax.numpy as jnp

    from gnss_sdr_1_tpu.track.engine import TrackState
    from gnss_sdr_1_tpu.track.loop_filter import FllPllState, IirState

    d = dict(leaves)
    d["carr_filter"] = FllPllState(*(jnp.asarray(a)
                                     for a in d["carr_filter"]))
    d["code_filter"] = IirState(*(jnp.asarray(a) for a in d["code_filter"]))
    return TrackState(**{k: (v if k in ("carr_filter", "code_filter")
                             else jnp.asarray(v)) for k, v in d.items()})


def _setup(signal):
    """Both engines, the shared starting state (the port's tracked over
    the case's head; the secondary-code signals then switched to the
    extended mode with the wipe at each channel's true, non-zero code
    index, and on GPS channel 0 to the extended mode) and the rest of the
    capture."""
    from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
    from gnss_sdr_1_tpu.track import TrackingEngine as JEngine

    fs, _, sec, head_s, span_s, _ = CASES[signal]
    sats, codes, sec_codes, x, rate = _capture(signal, head_s + span_s
                                               + 0.05)
    kw = _config(signal)
    ej = JEngine(JTrackConfig(**kw), codes, sec_codes=sec_codes)
    et = TrackingEngine(TrackConfig(**kw), codes, sec_codes=sec_codes,
                        device="cpu")
    head = int(fs * head_s)
    st, _ = et.track_capture(torch.from_numpy(x), _activate(et, sats, rate),
                             head)
    st_j = _state_from_jax(state_to_numpy(st))
    if sec is not None:
        n = len(sec)
        phases = st.epochs_in_track.numpy() % n
        assert (phases != 0).all(), phases
        for ch in range(N_CH):
            e = (n - int(phases[ch])) % n
            st = et.enable_extended(st, ch, e, sec_phase=int(phases[ch]))
            st_j = ej.enable_extended(st_j, ch, e, sec_phase=int(phases[ch]))
    elif signal == "1C":
        st = et.enable_extended(st, 0, 7)
        st_j = ej.enable_extended(st_j, 0, 7)
    np.testing.assert_equal(state_to_numpy(st), _leaves(st_j))
    return ej, et, _leaves(st_j), x[head:], int(fs * span_s)


def _close_f16(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=atol,
                               err_msg=what)


def _circular(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("signal", list(CASES))
def test_gather_engine_matches_jax(signal):
    """The bars above; on the GLONASS FDMA case (k = +-1, 562.5 kHz) the
    carrier loop at ROADMAP.md's long-track bars (Doppler within 1 Hz, CN0
    mean |diff| under 0.7 dB) and the prompt by its magnitude: the loop
    reads a float32 carrier ledger that grows by ~3,500 rad an epoch there,
    whose last bit XLA rounds otherwise (it fuses the ledger's
    multiply-add and divides by fs as a multiply by the reciprocal; ROADMAP
    §3, "the float32 carrier ledger at FDMA offsets"), so the two loops
    part by ~0.1 Hz within 60 ms while the epoch grid and the code loop
    hold the standard bars."""
    import jax.numpy as jnp

    from gnss_sdr_1_tpu.utils.planar import to_planar

    ej, et, leaves, x, span = _setup(signal)
    st_j, oj = ej.track_capture(jnp.asarray(to_planar(x)),
                                _state_from_jax(leaves), span)
    st_t, ot = et.track_capture(torch.from_numpy(x),
                                state_from_numpy(leaves, "cpu"), span)
    assert ot.valid.shape == oj.valid.shape
    np.testing.assert_array_equal(ot.valid, oj.valid)
    v = oj.valid
    period = et.cfg.code_period_s
    assert v.sum() >= N_CH * int(round(span / et.cfg.fs_hz / period)) - N_CH
    np.testing.assert_array_equal(ot.start[v], oj.start[v])
    np.testing.assert_array_equal(ot.cur_len[v], oj.cur_len[v])
    np.testing.assert_array_equal(ot.active, oj.active)
    fdma = CASES[signal][5] is not None
    dop_atol = 1.0 if fdma else 2e-2
    np.testing.assert_allclose(ot.carrier_doppler_hz[v],
                               oj.carrier_doppler_hz[v], rtol=0,
                               atol=dop_atol)
    np.testing.assert_allclose(ot.rem_code_phase_samples[v],
                               oj.rem_code_phase_samples[v], rtol=0,
                               atol=2e-2)
    assert _circular(ot.rem_carr_phase_rad[v],
                     oj.rem_carr_phase_rad[v]).max() <= 2e-2
    _close_f16(ot.code_freq_delta[v], oj.code_freq_delta[v], 2e-2, "delta")
    P = et.cfg.prompt_index
    pj = oj.correlators[..., P, 0] + 1j * oj.correlators[..., P, 1]
    pt = ot.correlators[..., P]
    scale = float(np.abs(pj[v]).max())
    if fdma:
        assert np.abs(ot.cn0_dbhz[v] - oj.cn0_dbhz[v]).mean() < 0.7
        _close_f16(np.abs(pt[v]), np.abs(pj[v]), 2e-4 * scale, "|prompt|")
    else:
        _close_f16(ot.cn0_dbhz[v], oj.cn0_dbhz[v], 2e-2, "cn0")
        _close_f16(pt.real[v], pj.real[v], 2e-4 * scale, "prompt I")
        _close_f16(pt.imag[v], pj.imag[v], 2e-4 * scale, "prompt Q")
    sj, stn = _leaves(st_j), state_to_numpy(st_t)
    for name in ("start", "cur_len", "push_count", "mode", "ext_cnt",
                 "active", "sec_idx", "lock_fail", "epochs_in_track"):
        np.testing.assert_array_equal(stn[name], sj[name], err_msg=name)
    np.testing.assert_allclose(stn["carrier_doppler_hz"],
                               sj["carrier_doppler_hz"], rtol=0,
                               atol=dop_atol)
    for name in ("code_freq_delta", "rem_code_phase_samples"):
        np.testing.assert_allclose(stn[name], sj[name], rtol=0, atol=2e-2,
                                   err_msg=name)


def test_track_capture_symbols_matches_jax():
    import jax.numpy as jnp

    from gnss_sdr_1_tpu.utils.planar import to_planar

    ej, et, leaves, x, span = _setup("1C")
    sym_off = np.array([20, 7, 13, 1], dtype=np.int32)
    st_j, sj = ej.track_capture_symbols(jnp.asarray(to_planar(x)),
                                        _state_from_jax(leaves), span,
                                        sym_off, 20)
    st_t, s_t = et.track_capture_symbols(torch.from_numpy(x),
                                         state_from_numpy(leaves, "cpu"),
                                         span, sym_off, 20)
    for name in ("start", "vcount", "n_valid", "active"):
        np.testing.assert_array_equal(getattr(s_t, name),
                                      getattr(sj, name), err_msg=name)
    for name in ("frac", "rem_carr_phase_rad", "carrier_doppler_hz"):
        np.testing.assert_allclose(getattr(s_t, name), getattr(sj, name),
                                   rtol=0, atol=2e-2, err_msg=name)
    scale = float(np.abs(sj.mean_i).max())
    for name in ("mean_i", "mean_q"):
        _close_f16(getattr(s_t, name), getattr(sj, name), 2e-4 * scale,
                   name)
    np.testing.assert_array_equal(state_to_numpy(st_t)["start"],
                                  _leaves(st_j)["start"])


# ---------------------------------------------------------------------------
# the kernel's launch geometry, the wrapper, and the kernel on the card
# ---------------------------------------------------------------------------

CU = pathlib.Path(gb.__file__).resolve().parent.parent / "csrc" \
    / "gather_block.cu"


def _cu_define(name):
    src = CU.read_text() + (CU.parent / "cluster_walk.cuh").read_text()
    m = re.search(rf"^#define {name} (\d+)$", src, re.M)
    assert m, f"{name} not defined in {CU.name} or cluster_walk.cuh"
    return int(m.group(1))


def test_kernel_constants_match_the_source():
    assert _cu_define("GB_THREADS") == gb.GB_THREADS
    assert _cu_define("GB_MAX_CLUSTER") == gb.GB_MAX_CLUSTER
    assert _cu_define("CLUSTER_SMEM_MAX") == cw.SMEM_MAX
    src = CU.read_text()
    assert '#include "cluster_walk.cuh"' in src
    assert "__launch_bounds__(GB_THREADS, 1)" in src
    assert "cudaLaunchKernelEx" in src and "cluster.sync()" in src
    assert _cu_define("GB_STAGE_POINTS") == gb.STAGE_POINTS
    assert _cu_define("GB_PRE_BYTES") == gb.PRE_BYTES
    assert "static_assert(sizeof(LoopPre) <= GB_PRE_BYTES" in src
    for name in ("TL_START", "TL_M0", "TL_PRE", "TL_RED", "TL_UPD", "TL_M32",
                 "TL_WAIT", "TL_SAMP", "TL_PART", "TL_HIT", "TL_PUB"):
        m = re.search(rf"^#define {name} (\d+) ", src, re.M)
        assert m and int(m.group(1)) == getattr(gb, name), name


def _synthetic_timeline(n, pre):
    """A timeline of n epochs of 1,000 cycles: the exchange of m 100
    cycles, the prefetch wait 10, the samples 500, the warp sums 40, the
    reduction 150, the closure 200; its state-only part, where stamped,
    30 cycles long, after m or beside the exchange from the publication of
    m (20 cycles after the start); the last epoch's channel idle."""
    tl = np.zeros((n, gb.STAGE_POINTS), np.int64)
    t0 = 5_000 + 1_000 * np.arange(n)
    tl[:, gb.TL_START] = t0
    tl[:, gb.TL_M0] = t0 + 90
    tl[:, gb.TL_M32] = t0 + 100
    tl[:, gb.TL_WAIT] = t0 + 110
    tl[:, gb.TL_SAMP] = t0 + 610
    tl[:, gb.TL_PART] = t0 + 650
    tl[:, gb.TL_RED] = t0 + 800
    tl[:, gb.TL_UPD] = t0 + 1_000
    if pre == "after_m":
        tl[:, gb.TL_PRE] = t0 + 120
    elif pre == "beside":
        tl[:, gb.TL_PUB] = t0 + 20
        tl[:, gb.TL_PRE] = t0 + 50
    tl[::2, gb.TL_HIT] = 1
    tl[-1, gb.TL_WAIT] = 0
    return tl


@pytest.mark.parametrize("pre", [None, "after_m", "beside"])
def test_stage_split_reads_a_synthetic_timeline(pre):
    n = 11
    tl = _synthetic_timeline(n, pre)
    # n epochs of 1,000 cycles in a launch of n us: 1,000 cycles a us
    sp = gb.stage_split(tl, n * 1e-3, 44)
    assert sp["epochs"] == n - 1 and sp["ordered"]
    assert sp["mhz"] == pytest.approx(1000.0)
    assert sp["epoch_us"] == pytest.approx(1.0)
    want = {"barrier_m": 0.1, "correlation": 0.55, "reduction": 0.15,
            "closure": 0.2}
    for k, v in want.items():
        assert sp["us"][k] == pytest.approx(v), k
        assert sp["share"][k] == pytest.approx(v), k
    assert sum(sp["share"].values()) == pytest.approx(1.0)
    assert sp["inner_us"]["prefetch_wait"] == pytest.approx(0.01)
    assert sp["inner_us"]["samples"] == pytest.approx(0.5)
    assert sp["inner_us"]["closure_pre"] == pytest.approx(0.03 if pre
                                                          else 0.0)
    assert sp["prefetch_hits"] == (n - 1 + 1) // 2
    assert sp["serial_floor_ms"] == pytest.approx(
        44 * (0.1 + 0.2 + (0.03 if pre else 0.0)) * 1e-3)
    # a span out of order (a clock read hoisted above its work) shows
    tl[3, gb.TL_PART] = tl[3, gb.TL_M32] - 1
    assert not gb.stage_split(tl, n * 1e-3, 44)["ordered"]
    with pytest.raises(ValueError):
        gb.stage_split(np.zeros_like(tl), 1.0, 44)


def _chip_smoke_shapes():
    """(what, C, K, n_max, code_len, sec_len) of the gather engine at every
    shape of chip_smoke.py's phase 2c, from the receivers' configurations
    as the script builds them (read from its GATHER_CHECKS)."""
    import chip_smoke as cs

    out = []
    for what, signal, fs, n_ch, _, _ in cs.GATHER_CHECKS:
        eng = cs._engine(torch.device("cpu"), fs, signal, "gather", n_ch)
        s = eng.gather_spec
        out.append((what, s.C, s.K, s.n_max, s.code_len, s.loop.sec_len))
    return out


@pytest.mark.parametrize("max_cluster", [8, 16])
def test_gather_geometry_at_chip_smoke_shapes(max_cluster):
    shapes = _chip_smoke_shapes()
    assert {w for w, *_ in shapes} >= {"GPS", "E1B", "L2C", "GPS C=20"}
    for what, C, K, n_max, code_len, sec_len in shapes:
        geo = gb.gather_geometry(C, K, n_max, code_len, sec_len,
                                 max_cluster)
        owned = [range(r, C, geo.n_cta) for r in range(geo.n_cta)]
        assert sorted(c for ch in owned for c in ch) == list(range(C))
        assert max(map(len, owned)) == geo.cpc and min(map(len, owned)) >= 1
        assert geo.n_cta == min(C, max_cluster)
        args = (geo.cpc, K, n_max, code_len, sec_len)
        with_pf = gb.gather_layout(*args, True)["total"]
        assert geo.prefetch == (with_pf <= cw.SMEM_MAX), what
        assert geo.smem == gb.gather_layout(*args, geo.prefetch)["total"]
        assert geo.smem <= cw.SMEM_MAX and geo.threads == gb.GB_THREADS
        if geo.prefetch:
            assert geo.pf_bytes >= 8 * (n_max + 1) and geo.pf_bytes % 16 == 0
        # an L2C epoch (~60,000 samples at 3 Msps) takes no prefetch; the
        # GPS, E1B, L5, E5a, B1I and GLONASS epochs take one a channel
        assert geo.prefetch == (what != "L2C"), what
        lay = gb.gather_layout(*args, geo.prefetch)
        offs = [lay[k] for k in ("bar", "slot", "info", "pf", "bits", "sf",
                                 "si", "sec", "part", "total")]
        assert offs == sorted(offs) and lay["pf"] % 16 == 0


def test_gather_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        gb.gather_geometry(0, 3, 4094, 1023, 1, 16)
    with pytest.raises(ValueError):
        gb.gather_geometry(4, 4, 4094, 1023, 1, 16)
    with pytest.raises(ValueError):
        gb.gather_geometry(4, 3, 4094, 1023, 1, 17)
    # 40 channels of an L2C code at 3 Msps in 16 CTAs: three a CTA, no room
    with pytest.raises(ValueError):
        gb.gather_geometry(400, 3, 60_000, 10230, 1, 1)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    _, et, leaves, x, span = _setup("1C")
    st = state_from_numpy(leaves, "cpu")
    fst, ist = et._pack_rows(st, span)
    slot = st.prn_slot.long()
    args = (torch.from_numpy(x), et._codes[slot].contiguous(),
            et._sec[slot].T.contiguous(), fst, ist)
    before = gb.launches
    got = gb.gather_block(et.gather_spec, *args, 8)
    want = gb.gather_block_plain(et.gather_spec, *args, 8)
    assert gb.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        gb.gather_block(et.gather_spec, args[0].to("meta"), *args[1:], 8)


@pytest.mark.gpu
@pytest.mark.parametrize("signal", ["1C", "1B", "L5", "1G", "2S"])
def test_gather_kernel_matches_plain_on_gpu(signal):
    """The kernel against gather_block_plain on the CPU over 80 ms of
    freshly activated channels: int rows exact, Doppler, delta and rem
    code within 2e-2, correlators within 1e-4 of max|corr| after turning
    by the entering carrier phases' difference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fs, _, sec, _, _, _ = CASES[signal]
    sats, codes, sec_codes, x, rate = _capture(signal, 0.14)
    et = TrackingEngine(TrackConfig(**_config(signal)), codes,
                        sec_codes=sec_codes, device="cpu")
    st = _activate(et, sats, rate)
    span = int(fs * 0.08)
    fst, ist = et._pack_rows(st, span)
    slot = st.prn_slot.long()
    args = (torch.from_numpy(x), et._codes[slot].contiguous(),
            et._sec[slot].T.contiguous(), fst, ist)
    n_ep = et._check_capture(args[0], span)
    want = gb.gather_block_plain(et.gather_spec, *args, n_ep)
    before = gb.launches
    got = gb.gather_block(et.gather_spec, *(a.cuda() for a in args), n_ep)
    torch.cuda.synchronize()
    assert gb.launches == before + 1
    of, oi, oc, fst_g, ist_g = (t.cpu().numpy() for t in got)
    wf, wi, wc, fst_w, ist_w = (t.numpy() for t in want)
    np.testing.assert_array_equal(oi, wi)
    np.testing.assert_array_equal(ist_g, ist_w)
    v = wf[:, 5] > 0.5
    assert v.sum() > 0
    for row in (0, 1, 2):
        np.testing.assert_allclose(of[:, row][v], wf[:, row][v], rtol=0,
                                   atol=2e-2)
    K = oc.shape[1] // 2
    turn = np.zeros(of.shape[::2])
    turn[1:] = of[:-1, 3] - wf[:-1, 3]
    g = (oc[:, :K] + 1j * oc[:, K:]) * np.exp(1j * turn)[:, None]
    w = wc[:, :K] + 1j * wc[:, K:]
    assert np.abs(g - w).max() <= 1.5e-4 * np.abs(w).max()
