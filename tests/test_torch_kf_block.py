"""The KF block walk (ops/kf_block.py) and the port's KF engine on every
signal, on the CPU against the JAX package's KF engine and receiver, on the
same numpy inputs made from seeds; and the kernel against its plain
version on a GPU (skipped without one).

Bars (tests/test_torch_kf.py, test_kf_track_block_matches_jax): int rows
and the carried int state exact; Doppler, code-frequency delta and rem
code phase at atol 2e-2; correlators at 1e-4 of max|corr|; rem carrier
phase at 1e-4 2 pi, circular; CN0 and sigma2 at rtol 1e-3.  As there, the
GPS cases start the code phases half a sample off the sample grid, with
Dopplers that keep them off it, and low Dopplers keep the unwrapped phase
state small, where one float32 unit of it stays well under the
correlator bar (ROADMAP.md §3, Traps).

JAX is imported inside the tests that use it, so that the GPU case runs
on a machine without JAX:
    python -m pytest --noconftest -m gpu tests/test_torch_kf_block.py"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import tracking_replica
from gnss_sdr_1_tpu_torch.constants import SIGNALS
from gnss_sdr_1_tpu_torch.ops import kf_block as kb
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import kf as tkf

BLOCK_S = 0.04


def _jax_state_numpy(st) -> dict:
    out = {}
    for k, v in st._asdict().items():
        if k == "code_filter":
            out[k] = (np.asarray(v.inputs), np.asarray(v.outputs))
        else:
            out[k] = np.asarray(v)
    return out


def _circ(a, b):
    d = np.abs(np.asarray(a, np.float64) - b)
    return np.minimum(d, 2 * np.pi - d)


def _cfg_kw(signal, fs, n_ch, **kw):
    """KfTrackConfig keywords as the receivers build them (the virtual
    half-chip basis for E1B)."""
    spec = SIGNALS[signal]
    code, rate, spc = tracking_replica(signal, 1)
    return dict(fs_hz=fs, code_length_chips=len(code),
                chip_rate_chips_s=rate, carrier_freq_hz=spec.carrier_freq_hz,
                n_channels=n_ch, early_late_space_chips=0.5 * spc, **kw)


def _capture(signal, prns, sats, fs, n, bit_rate_bps=None):
    """n samples of `sats` on the signal's tracking replicas (seeded
    noise); `bit_rate_bps` replaces the spec's (the satellites' nav_bits
    then carry a secondary code, one chip a code period)."""
    spec = SIGNALS[signal]
    reps = {p: tracking_replica(signal, p) for p in prns}
    rate = reps[prns[0]][1]
    gen = dataclasses.replace(spec, code_rate_chips_s=rate,
                              code_length_chips=len(reps[prns[0]][0]),
                              bit_rate_bps=bit_rate_bps or spec.bit_rate_bps)
    x = generate_baseband(gen, sats, {p: reps[p][0] for p in prns}, fs,
                          n / fs + 1e-3, noise=True, seed=21)
    return x[:n]


def _assert_outputs_match(got_f, got_i, want, what):
    """Packed output rows of the port against the JAX KfTrackOutputs
    (stacked over blocks) at the module's bars."""
    v = np.asarray(want.valid)
    assert v.any(), what
    np.testing.assert_array_equal(got_i[:, kb.OI_VALID] != 0, v, what)
    for row, name in ((kb.OI_START, "start"), (kb.OI_CURLEN, "cur_len")):
        np.testing.assert_array_equal(got_i[:, row],
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_array_equal(got_i[:, kb.OI_ACTIVE] != 0,
                                  np.asarray(want.active), what)
    for row, name in ((kb.O_DOPPLER, "carrier_doppler_hz"),
                      (kb.O_DELTA, "code_freq_delta"),
                      (kb.O_REM_CODE, "rem_code_phase_samples"),
                      (kb.O_DOPPLER_RATE, "doppler_rate_hz_s")):
        np.testing.assert_allclose(got_f[:, row][v],
                                   np.asarray(getattr(want, name))[v],
                                   rtol=0, atol=2e-2, err_msg=f"{what} {name}")
    cj = np.asarray(want.correlators)                # [E, C, 3, 2]
    cj = np.concatenate([cj[..., 0], cj[..., 1]], axis=-1).transpose(0, 2, 1)
    ct = got_f[:, kb.O_CORR:kb.O_CORR + 6]
    assert np.abs(ct - cj).max() <= 1e-4 * np.abs(cj).max(), what
    assert _circ(got_f[:, kb.O_REM_CARR][v],
                 np.asarray(want.rem_carr_phase_rad)[v]).max() \
        <= 1e-4 * 2 * np.pi, what
    for row, name in ((kb.O_CN0, "cn0_dbhz"),
                      (kb.O_SIGMA2, "carr_phase_sigma2")):
        np.testing.assert_allclose(got_f[:, row][v],
                                   np.asarray(getattr(want, name))[v],
                                   rtol=1e-3, atol=1e-4,
                                   err_msg=f"{what} {name}")


def _assert_state_match(nt, nj, what):
    for k in ("active", "prn_slot", "start", "cur_len", "hist_count",
              "lock_fail", "epochs"):
        np.testing.assert_array_equal(nt[k], nj[k], err_msg=f"{what} {k}")
    np.testing.assert_allclose(nt["x"][:, 1:], nj["x"][:, 1:], rtol=0,
                               atol=2e-2, err_msg=what)


# ---------------------------------------------------------------------------
# kf_block_plain over packed buffers against the JAX engine
# ---------------------------------------------------------------------------

# name: (signal, fs, order, bayes_run); NIW from epoch 10, in use from 20
BLOCK_CASES = {
    "gps_order2": ("1C", 4.092e6, 2, False),
    "gps_order3": ("1C", 4.092e6, 3, False),
    "gps_order2_niw": ("1C", 4.092e6, 2, True),
    "gps_order3_niw": ("1C", 4.092e6, 3, True),
    "e1b_virtual_basis": ("1B", 4.0e6, 2, False),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_kf_block_plain_matches_jax(case):
    """Two 40 ms blocks: the JAX engine's track_block twice against one
    kf_block_plain walk over the packed state rows, unpacked after."""
    from gnss_sdr_1_tpu.track import kf as jkf

    signal, fs, order, bayes = BLOCK_CASES[case]
    prns = [1, 2]
    kw = _cfg_kw(signal, fs, len(prns), order=order, bayes_run=bayes,
                 **({"bayes_ptrans": 10, "bayes_strans": 10} if bayes
                    else {}))
    codes = np.stack([tracking_replica(signal, p)[0] for p in prns])
    ej = jkf.KfTrackingEngine(jkf.KfTrackConfig(**kw), codes)
    et = tkf.KfTrackingEngine(tkf.KfTrackConfig(**kw), codes, device="cpu")
    rate = kw["chip_rate_chips_s"]
    # GPS: half a sample off the grid (4 samples per chip); E1B's 4 Msps is
    # not commensurate with its 2.046 MHz virtual rate
    sats = [SatParams(prn=p, doppler_hz=20.0 + 100.0 * i,
                      doppler_rate_hz_s=10.0 if order == 3 else 0.0,
                      delay_chips=(100.125 + 300.0 * i) * (
                          1 if signal == "1C" else 8),
                      cn0_dbhz=45.0)
            for i, p in enumerate(prns)]
    base = int(round(fs * BLOCK_S))
    nmax = et.cfg.epoch_samples_max
    x = _capture(signal, prns, sats, fs, 2 * base + nmax)
    sj = ej.init_state()
    for ch, s in enumerate(sats):
        sj = ej.activate_channel(sj, ch, ch, s.delay_chips / rate * fs,
                                 s.doppler_hz, 0, 0, doppler_step_hz=250.0)
    st = tkf.kf_state_from_numpy(_jax_state_numpy(sj), "cpu")
    sj1, oj1 = ej.track_block(x[: base + nmax], sj, base)
    sj2, oj2 = ej.track_block(x[base:], sj1, base)
    want = type(oj1)(*(np.concatenate([np.asarray(a), np.asarray(b)])
                       for a, b in zip(oj1, oj2)))

    spec = et.block_spec(base, 2)
    assert spec.n_epochs == base // (et._t0_int - 2) + 2
    fst, ist = et.pack_state(st)
    assert fst.shape == (kb.n_frows(et.cfg.cn0_samples), len(prns))
    assert ist.shape == (kb.N_IROWS, len(prns))
    out_f, out_i, fst2, ist2 = kb.kf_block_plain(
        spec, torch.as_tensor(x), et._codes, fst, ist)
    assert out_f.shape == (2 * spec.n_epochs, kb.N_OROWS, len(prns))
    assert int((out_i[:, kb.OI_VALID] != 0).sum()) >= 0.9 * (
        2 * BLOCK_S / et.cfg.code_period_s) * len(prns)
    _assert_outputs_match(out_f.numpy(), out_i.numpy(), want, case)
    _assert_state_match(tkf.kf_state_to_numpy(et.unpack_state(fst2, ist2)),
                        _jax_state_numpy(sj2), case)
    # the packed layout round-trips
    back = et.unpack_state(*et.pack_state(et.unpack_state(fst2, ist2)))
    for a, b in zip(tkf.kf_state_to_numpy(back).values(),
                    tkf.kf_state_to_numpy(et.unpack_state(fst2,
                                                          ist2)).values()):
        for u, w in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            np.testing.assert_array_equal(u, w)


def test_track_blocks_is_the_block_loop():
    """One engine call over three blocks equals three one-block calls (the
    receiver's segment against the JAX package's block loop), with the
    epoch starts made relative to the segment."""
    prns = [3, 8]
    fs = 2.6e6
    et = tkf.KfTrackingEngine(
        tkf.KfTrackConfig(**_cfg_kw("1C", fs, 2)),
        np.stack([tracking_replica("1C", p)[0] for p in prns]), device="cpu")
    sats = [SatParams(prn=p, doppler_hz=-900.0 + 1300.0 * i,
                      delay_chips=211.3 + 400.0 * i, cn0_dbhz=44.0)
            for i, p in enumerate(prns)]
    base = int(round(fs * BLOCK_S))
    nmax = et.cfg.epoch_samples_max
    x = _capture("1C", prns, sats, fs, 3 * base + nmax)
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * fs,
                                 s.doppler_hz, 0, 0, doppler_step_hz=250.0)
    s3, o3 = et.track_blocks(x, st, base, 3)
    s1, pieces = st, []
    for b in range(3):
        s1, o = et.track_block(x[b * base: (b + 1) * base + nmax], s1, base)
        pieces.append(o._replace(start=o.start + b * base))
    for name, a in o3._asdict().items():
        np.testing.assert_array_equal(
            a, np.concatenate([getattr(p, name) for p in pieces]), name)
    for a, b in zip(tkf.kf_state_to_numpy(s3).values(),
                    tkf.kf_state_to_numpy(s1).values()):
        for u, w in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            np.testing.assert_array_equal(u, w)
    assert o3.valid.sum() >= 0.9 * 3 * BLOCK_S * 1e3 * 2


def test_kf_block_wrapper_takes_the_plain_walk_on_the_cpu():
    et = tkf.KfTrackingEngine(
        tkf.KfTrackConfig(**_cfg_kw("1C", 2.046e6, 1)),
        tracking_replica("1C", 1)[0][None], device="cpu")
    base = 20_460
    spec = et.block_spec(base)
    x = torch.zeros(base + et.cfg.epoch_samples_max, dtype=torch.complex64)
    fst, ist = et.pack_state(et.init_state())
    before = kb.launches
    out_f, out_i, _, ist2 = kb.kf_block(spec, x, et._codes, fst, ist)
    assert kb.launches == before
    assert not out_i[:, kb.OI_VALID].any()
    np.testing.assert_array_equal(ist2[kb.I_START].numpy(),
                                  ist[kb.I_START].numpy() - base)
    with pytest.raises(ValueError):
        kb.kf_block(spec, x, et._codes, fst, ist.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kb.check_inputs(spec, x, et._codes, fst, ist)


# ---------------------------------------------------------------------------
# the KF engine as each receiver builds it, on every signal
# ---------------------------------------------------------------------------

# name: (signal, fs, PRNs, FDMA k per PRN, epochs per block)
SIGNAL_CASES = {
    "L5": ("L5", 12.5e6, (1, 3), (), 10),
    "5X": ("5X", 12.0e6, (11, 12), (), 10),
    "2S": ("2S", 2.046e6, (1, 2), (), 2),
    "1G_k0": ("1G", 4.092e6, (1, 2), ((1, 0), (2, 0)), 10),
    "1G_k1": ("1G", 4.092e6, (3,), ((3, 1),), 10),
    "2G": ("2G", 4.092e6, (1, 2), (), 10),
    "B1": ("B1", 4.0e6, (6, 7), (), 10),
    "B3": ("B3", 12.5e6, (6, 7), (), 10),
}


def _secondary(signal):
    """The data channel's secondary code (one chip per 1 ms code period),
    or None."""
    from gnss_sdr_1_tpu_torch.codes import BEIDOU_NH20, NH10
    from gnss_sdr_1_tpu_torch.codes.galileo_e5 import galileo_e5ai_secondary

    return {"L5": NH10, "5X": galileo_e5ai_secondary(), "B1": BEIDOU_NH20,
            "B3": BEIDOU_NH20}.get(signal)


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_kf_engine_of_each_receiver_matches_jax(case):
    """One block of the KF engine each receiver builds for `case` (JAX
    runtime/receiver.py:308-328), activated as the receivers activate a
    channel: at the acquisition's Doppler, which on GLONASS excludes the
    slot's FDMA offset, since the KF tracks at the nominal carrier (k = 1:
    562.5 kHz off, so neither engine holds the signal; both agree).  On
    L5, E5a, B1I and B3I the capture carries the secondary code: the
    two-quadrant Costas measurement does not see its sign flips, and both
    engines hold the signal through them."""
    from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
    from gnss_sdr_1_tpu.runtime import ReceiverConfig as JCfg
    from gnss_sdr_1_tpu_torch.constants import glonass_fdma_offset_hz
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    signal, fs, prns, fdma, n_code = SIGNAL_CASES[case]
    kw = dict(fs_hz=fs, signal_id=signal, n_channels=len(prns),
              prn_search=prns, track_engine="kf", fdma_k=fdma)
    rj = JReceiver(JCfg(**kw))
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    ej, et = rj.trk, rt.trk
    assert isinstance(et, tkf.KfTrackingEngine)
    assert dataclasses.asdict(ej.cfg) == dataclasses.asdict(et.cfg)
    assert et.cfg.carrier_freq_hz == SIGNALS[signal].carrier_freq_hz
    np.testing.assert_array_equal(np.asarray(ej._codes), et._codes.numpy())
    assert rj._slot_of_prn == rt._slot_of_prn
    cfg = et.cfg
    rate = cfg.chip_rate_chips_s
    spc = fs / rate
    ks = dict(fdma)
    sec = _secondary(signal)
    base = n_code * int(round(fs * cfg.code_period_s))
    n_sec = base // int(round(fs * cfg.code_period_s)) + 4
    sats = [SatParams(prn=p, doppler_hz=60.0 + 80.0 * i,
                      delay_chips=0.25 / spc * (1 + 2 * i)
                      + (0.3 + 0.4 * i) * cfg.code_length_chips,
                      cn0_dbhz=46.0,
                      carrier_offset_hz=glonass_fdma_offset_hz(
                          signal, ks[p]) if p in ks else 0.0,
                      nav_bits=None if sec is None else np.resize(
                          np.roll(sec, 3 * i), n_sec))
            for i, p in enumerate(prns)]
    x = _capture(signal, list(prns), sats, fs, base + cfg.epoch_samples_max,
                 bit_rate_bps=None if sec is None else 1.0
                 / cfg.code_period_s)
    sj = ej.init_state()
    for ch, s in enumerate(sats):
        sj = ej.activate_channel(sj, ch, rj._slot_of_prn[s.prn],
                                 s.delay_chips / rate * fs, s.doppler_hz, 0,
                                 0, doppler_step_hz=rj.cfg.doppler_step_hz)
    st = tkf.kf_state_from_numpy(_jax_state_numpy(sj), "cpu")
    sj2, oj = ej.track_block(x, sj, base)
    fst, ist = et.pack_state(st)
    out_f, out_i, fst2, ist2 = kb.kf_block_plain(
        et.block_spec(base), torch.as_tensor(x), et._codes, fst, ist)
    _assert_outputs_match(out_f.numpy(), out_i.numpy(), oj, case)
    _assert_state_match(tkf.kf_state_to_numpy(et.unpack_state(fst2, ist2)),
                        _jax_state_numpy(sj2), case)
    # the prompt against the noise floor (sqrt of the samples integrated):
    # held where the carrier is the nominal one, lost 562.5 kHz off it
    of, oi = out_f.numpy(), out_i.numpy()
    v = oi[:, kb.OI_VALID] != 0
    prompt = np.hypot(of[:, kb.O_CORR + 1], of[:, kb.O_CORR + 4])
    snr = (prompt / np.sqrt(oi[:, kb.OI_CURLEN]))[v]
    if case == "1G_k1":
        assert snr.max() < 4.0
    else:
        assert snr[-len(prns):].min() > 4.0
    if sec is not None:
        # the prompt's in-phase sign follows the secondary code's flips
        pi_ = of[v.all(axis=1), kb.O_CORR + 1][2:]
        assert (np.diff(np.sign(pi_), axis=0) != 0).any()


def test_every_signal_takes_the_kf_tracker():
    """ReceiverConfig(signal_id=s, track_engine='kf') is accepted for every
    signal the JAX ReceiverConfig accepts, and the Receiver builds its KF
    engine (in the virtual basis on E1B)."""
    from gnss_sdr_1_tpu.runtime import ReceiverConfig as JCfg
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    for sid in ("1C", "1B", "L5", "5X", "2S", "1G", "2G", "B1", "B3"):
        JCfg(signal_id=sid, track_engine="kf")
        rx = Receiver(ReceiverConfig(signal_id=sid, track_engine="kf",
                                     prn_search=(1,) if sid != "B1"
                                     else (6,)), device="cpu")
        assert rx.trk_kind == "kf" and isinstance(rx.trk,
                                                  tkf.KfTrackingEngine)
        code, rate, spc = tracking_replica(sid, 1 if sid != "B1" else 6)
        assert rx.trk.cfg.code_length_chips == len(code)
        assert rx.trk.cfg.chip_rate_chips_s == rate
        assert (spc == 2) == (sid == "1B")


# ---------------------------------------------------------------------------
# both receivers with the KF tracker on Galileo E1B
# ---------------------------------------------------------------------------


def test_kf_receivers_agree_on_boc_signal():
    """tests/test_kf_tracking.py::test_kf_tracks_boc_signal's scenario
    (E1B PRN 5, 1 channel, 3 s at 4 Msps, -1234 Hz) through both packages'
    receivers: the same assignment, acquisition, symbol count and bit
    offset, final Dopplers within 1 Hz of each other and 25 Hz of the
    truth."""
    from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
    from gnss_sdr_1_tpu.runtime import ReceiverConfig as JCfg
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    fs, prn, true_dop = 4.0e6, 5, -1234.0
    code, rate, spc = tracking_replica("1B", prn)
    spec = dataclasses.replace(SIGNALS["1B"], code_rate_chips_s=2.046e6,
                               code_length_chips=2 * 4092,
                               bit_rate_bps=250.0)
    x = generate_baseband(
        spec, [SatParams(prn=prn, doppler_hz=true_dop, delay_chips=1000.25,
                         cn0_dbhz=48.0)],
        {prn: code}, fs, 3.0, noise=True, seed=11)
    kw = dict(fs_hz=fs, signal_id="1B", n_channels=1, prn_search=(prn,),
              track_engine="kf", acq_dwells=3, watchdog_symbols=0)
    rj = JReceiver(JCfg(**kw))
    rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    rt.process(x)
    assert rt.trk.cfg.code_length_chips == rj.trk.cfg.code_length_chips \
        == 2 * 4092
    assert rt.channel_prn == rj.channel_prn == [prn]
    (dj, fj, sj), (dt, ft, st) = rj._acq_info[prn], rt._acq_info[prn]
    assert ft == fj and st == sj and abs(dt - dj) <= 1.0
    assert rt.sym_count == rj.sym_count and rt.sym_count[prn] > 600
    assert getattr(rt.decoders[prn], "bit_offset", None) == getattr(
        rj.decoders[prn], "bit_offset", None)
    assert rt.decoders[prn].raw.page_sync == rj.decoders[prn].raw.page_sync
    dop_t = float(rt.state.x[0, 1])
    dop_j = float(np.asarray(rj.state.x)[0, 1])
    assert abs(dop_t - dop_j) <= 1.0
    assert abs(dop_t - true_dop) < 25.0 and abs(dop_j - true_dop) < 25.0


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain walk (needs a GPU)
# ---------------------------------------------------------------------------


# the kernel's cases: BLOCK_CASES on 8 channels (one thread block each in
# one cluster), and GPS on 1 channel and on 20 (rounds: CTAs of a cluster
# of 16 or fewer take two channels or more)
GPU_CASES = {**{k: (*v, 8) for k, v in BLOCK_CASES.items()},
             "gps_one_channel": ("1C", 4.092e6, 2, False, 1),
             "gps_20_channels": ("1C", 4.092e6, 2, False, 20)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_kf_block_kernel_matches_plain_on_gpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA KF kernel has no CPU "
                    "mode)")
    signal, fs, order, bayes, n_ch = GPU_CASES[case]
    prns = list(range(1, n_ch + 1))
    kw = _cfg_kw(signal, fs, len(prns), order=order, bayes_run=bayes,
                 **({"bayes_ptrans": 10, "bayes_strans": 10} if bayes
                    else {}))
    et = tkf.KfTrackingEngine(
        tkf.KfTrackConfig(**kw),
        np.stack([tracking_replica(signal, p)[0] for p in prns]),
        device="cpu")
    rate = kw["chip_rate_chips_s"]
    # Dopplers over the same 630 Hz however many channels (low, so the
    # unwrapped phase state stays small)
    sats = [SatParams(prn=p, doppler_hz=-300.0 + 720.0 * i / max(n_ch, 8),
                      delay_chips=0.5 * rate / fs + 37.0 + 97.0 * i,
                      cn0_dbhz=45.0) for i, p in enumerate(prns)]
    base = int(round(fs * BLOCK_S))
    x = torch.as_tensor(_capture(signal, prns, sats, fs,
                                 2 * base + et.cfg.epoch_samples_max))
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / rate * fs,
                                 s.doppler_hz, 0, 0, doppler_step_hz=250.0)
    spec = et.block_spec(base, 2)
    fst, ist = et.pack_state(st)
    want = [t.numpy() for t in kb.kf_block_plain(spec, x, et._codes, fst,
                                                 ist)]
    before = kb.launches
    got = kb.kf_block(spec, *(t.cuda() for t in (x, et._codes, fst, ist)))
    torch.cuda.synchronize()
    assert kb.launches == before + 1
    got = [t.cpu().numpy() for t in got]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    v = want[1][:, kb.OI_VALID] != 0
    assert v.sum() > 0.9 * 2 * BLOCK_S / et.cfg.code_period_s * len(prns)
    for row in (kb.O_DOPPLER, kb.O_DELTA, kb.O_REM_CODE):
        assert np.abs(got[0][:, row] - want[0][:, row])[v].max() <= 2e-2
    c = slice(kb.O_CORR, kb.O_CORR + 6)
    assert np.abs(got[0][:, c] - want[0][:, c]).max() \
        <= 1e-4 * np.abs(want[0][:, c]).max()
    assert _circ(got[0][:, kb.O_REM_CARR][v],
                 want[0][:, kb.O_REM_CARR][v]).max() <= 1e-4 * 2 * np.pi
    for row in (kb.O_CN0, kb.O_SIGMA2):
        np.testing.assert_allclose(got[0][:, row][v], want[0][:, row][v],
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_kf_receivers_agree_on_galileo_system_scenario():
    """tests/test_system_galileo.py's scenario (5 E1B satellites, 18 s at
    4 Msps) through both packages' receivers with the KF tracker: the
    same channels, Dopplers within 1 Hz of each other and of the truth,
    the same ephemerides, fix count and first fix, positions within 10 cm
    of each other.  Both sit ~190 m off the truth: the KF's E-L spacing
    of 0.5 chip (1 virtual chip) puts Early and Late on the sinBOC
    correlation's side lobes, where the discriminator is flat (ROADMAP.md
    §3), so the code loop drifts with the noise and the two packages'
    rounding moves their positions apart by up to ~4 cm; this holds the
    port to the JAX package there."""
    from test_torch_capture_cache import cached_capture

    from gnss_sdr_1_tpu.pvt.geodesy import llh_to_ecef
    from gnss_sdr_1_tpu.runtime import Receiver as JReceiver
    from gnss_sdr_1_tpu.runtime import ReceiverConfig as JCfg
    from gnss_sdr_1_tpu.siggen.scenario import build_scenario
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    fs, dur, prns = 4.0e6, 18.0, [1, 2, 3, 4, 5]
    rx_ecef = llh_to_ecef(np.radians(41.275), np.radians(1.988), 80.0)
    scen = build_scenario(rx_ecef, prns, t0_tow=345601.25, duration_s=dur,
                          cn0_dbhz=48.0, chip_rate=2.046e6, signal="1B")
    spec = dataclasses.replace(SIGNALS["1B"], code_rate_chips_s=2.046e6,
                               code_length_chips=2 * 4092,
                               bit_rate_bps=250.0)
    x = cached_capture(
        "sysgal_kf_4000000_18_v1",
        lambda: generate_baseband(
            spec, scen.sats, {p: tracking_replica("1B", p)[0] for p in prns},
            fs, dur, noise=True))
    kw = dict(fs_hz=fs, signal_id="1B", n_channels=5, prn_search=tuple(prns),
              acq_dwells=3, pll_bw_hz=15.0, dll_bw_hz=2.0, track_engine="kf")
    rj = JReceiver(JCfg(**kw))
    sj = rj.process(x)
    rt = Receiver(ReceiverConfig(**kw), device="cpu")
    rt.preload(x)
    st = rt.process(x)
    assert rt.channel_prn == rj.channel_prn and None not in rt.channel_prn
    assert bool(np.all(rt.state.active.numpy()))
    dop_t = rt.state.x[:, 1].numpy()
    dop_j = np.asarray(rj.state.x)[:, 1]
    truth = {s.prn: s.doppler_hz + s.doppler_rate_hz_s * dur
             + 0.5 * s.doppler_rate2_hz_s2 * dur ** 2 for s in scen.sats}
    for ch, p in enumerate(rt.channel_prn):
        assert abs(dop_t[ch] - dop_j[ch]) <= 1.0
        assert abs(dop_t[ch] - truth[p]) <= 25.0
    assert {p for p, d in rt.decoders.items() if d.ephemeris_complete} \
        == {p for p, d in rj.decoders.items() if d.ephemeris_complete}
    assert len(st) == len(sj) >= 10
    assert st[0].rx_time_tow_s == pytest.approx(sj[0].rx_time_tow_s,
                                                abs=1e-6)
    np.testing.assert_allclose(np.stack([s.rx_ecef_m for s in st]),
                               np.stack([s.rx_ecef_m for s in sj]),
                               rtol=0, atol=0.1)
