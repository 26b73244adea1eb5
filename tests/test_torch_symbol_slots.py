"""The symbol-grid reduction (ops/symbol_slots.py).

- `symbol_slots_plain` against a straightforward numpy loop over every
  slot of every channel, bit for bit (the float fields viewed as int32, so
  zeros' signs count): GPS (C = 8, N = 20, cap = 1008, not a multiple of
  N) with every offset in 1..N, E1B (N = 1, K = 5), a cap that is a
  multiple of N, a cap shorter than one symbol, channels that drop mid
  segment or are never valid; rem_code steps of exact halves (round half
  to even).
- The packed buffer: `unpack` gives back the fields packed as the kernel
  packs them; the engine's CPU path returns the plain version's fields
  and counts no launch; the parameter block holds up to SYM_MAX_C
  channels and refuses more; the kernel's wrapper refuses CPU rows.
- On the card (gpu-marked, skips without one; `python -m pytest
  --noconftest -m gpu tests/test_torch_symbol_slots.py` on the GPU
  machine): the kernel against the plain version on the card, bit for bit,
  at the same cases through both walks' libraries, one launch a call; and
  on the rows of a real GPS walk and a real E1B gather walk, through the
  engine's `_symbol_outputs`.
"""

import ctypes
import pathlib
import types

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import (galileo_e1_sinboc11,
                                        galileo_e1b_code, gps_l1ca_code)
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.ops import _build
from gnss_sdr_1_tpu_torch.ops import symbol_slots as ss
from gnss_sdr_1_tpu_torch.ops.track_chain import (N_OROWS, O_ACTIVE,
                                                  O_CN0, O_DELTA,
                                                  O_DOPPLER, O_REM_CARR,
                                                  O_REM_CODE, O_VALID)
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _gps(first):
    """GPS L1 C/A: 8 channels, offsets first, first + 1, ... (mod N)."""
    return dict(cap=1008, C=8, N=20, K=3, prompt=1,
                off=[(first - 1 + c) % 20 + 1 for c in range(8)])


CASES = {
    "gps_off1": _gps(1),
    "gps_off9": _gps(9),
    "gps_off17": _gps(17),
    # channel 1 loses lock at epoch 99, 3 is never valid
    "e1b": dict(cap=252, C=4, N=1, K=5, prompt=2, off=[1, 1, 1, 1],
                drop={1: 100, 3: 0}),
    # channel 2 loses lock at epoch 499, 5 is never valid, 7 only at 0
    "gps_drop": dict(_gps(5), drop={2: 500, 5: 0, 7: 1}),
    "cap_multiple": dict(cap=1000, C=3, N=20, K=3, prompt=1,
                         off=[20, 1, 13]),
    "cap_short": dict(cap=16, C=2, N=20, K=3, prompt=1, off=[7, 20]),
    "nh_slots": dict(cap=1006, C=5, N=4, K=3, prompt=1,
                     off=[1, 2, 3, 4, 2]),
}


def _rows(case, seed=0):
    """Per-epoch rows in numpy as a walk leaves them, with random values
    where the reduction reads (negative correlators on invalid epochs, so
    -0.0 products occur) and rem_code on a quarter-sample grid in half the
    channels (exact .5 steps)."""
    cap, C, K = case["cap"], case["C"], case["K"]
    rng = np.random.default_rng(seed)
    out_f = (rng.standard_normal((cap, N_OROWS, C)) * 100).astype(
        np.float32)
    valid = np.ones((cap, C), np.float32)
    active = np.ones((cap, C), np.float32)
    for c, e in case.get("drop", {}).items():
        valid[e:, c] = 0.0
        active[max(e - 1, 0):, c] = 0.0
    out_f[:, O_VALID] = valid
    out_f[:, O_ACTIVE] = active
    rem = rng.uniform(-3.0, 3.0, (cap, C)).astype(np.float32)
    grid = rng.integers(-12, 12, (cap, C)).astype(np.float32) * 0.25
    rem[:, ::2] = grid[:, ::2]
    out_f[:, O_REM_CODE] = rem
    out_i = rng.integers(-(1 << 20), 1 << 20, (cap, 2, C)).astype(np.int32)
    out_corr = (rng.standard_normal((cap, 2 * K, C)) * 1000).astype(
        np.float32)
    entering = rng.integers(-8, 8, C).astype(np.float32) * 0.25
    return out_f, out_i, out_corr, entering


def _numpy_slots(out_f, out_i, out_corr, entering, off, N, prompt):
    """The reduction as a loop over channels and slots: slot s of a
    channel with boundary b0 holds epochs b0 - N + sN + k, k < N, in order;
    epochs outside [0, cap) are +0.0 padding; the sum starts from the first
    row's value."""
    cap, _, C = out_f.shape
    K = out_corr.shape[1] // 2
    S = cap // N + 2
    f32 = np.float32
    scale = f32(1.0 / N)
    out = {f: np.zeros((S, C), np.float32) for f in ss.FIELDS[1:8]}
    out["start"] = np.zeros((S, C), np.int32)
    out["vcount"] = np.zeros((S, C), np.int32)
    out["n_valid"] = np.zeros(C, np.int32)
    out["active"] = np.zeros(C, bool)
    for c in range(C):
        b0 = int(off[c])
        v = out_f[:, O_VALID, c]
        for s in range(S):
            sums = [f32(0.0)] * 3
            for k in range(N):
                e = b0 - N + s * N + k
                x = ((out_corr[e, prompt, c] * v[e],
                      out_corr[e, K + prompt, c] * v[e], v[e])
                     if 0 <= e < cap else (f32(0.0),) * 3)
                sums = list(x) if k == 0 else [f32(a + b)
                                               for a, b in zip(sums, x)]
            es = min(max(b0 - N + s * N, 0), cap - 1)
            em1 = max(es - 1, 0)
            r = out_f[em1, O_REM_CODE, c]
            prev = entering[c] if em1 == 0 else out_f[em1 - 1, O_REM_CODE, c]
            out["start"][s, c] = out_i[es, 0, c]
            out["mean_i"][s, c] = sums[0] * scale
            out["mean_q"][s, c] = sums[1] * scale
            out["frac"][s, c] = r - np.rint(f32(r - prev))
            out["rem_carr_phase_rad"][s, c] = out_f[em1, O_REM_CARR, c]
            out["carrier_doppler_hz"][s, c] = out_f[em1, O_DOPPLER, c]
            out["cn0_dbhz"][s, c] = out_f[em1, O_CN0, c]
            out["code_freq_delta"][s, c] = out_f[em1, O_DELTA, c]
            out["vcount"][s, c] = int(sums[2])
        n = int(np.count_nonzero(v))
        out["n_valid"][c] = n
        out["active"][c] = out_f[min(max(n - 1, 0), cap - 1), O_ACTIVE,
                                 c] > 0.5
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want) == set(ss.FIELDS)
    for f in ss.FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert np.array_equal(_bits(g), _bits(w)), f


def _tensors(rows, dev):
    return [torch.from_numpy(a).to(dev) for a in rows]


def _plain(case, rows, dev="cpu"):
    t = _tensors(rows, dev)
    return ss.symbol_slots_plain(*t, np.array(case["off"]), case["N"],
                                 case["prompt"])


def _host(fields):
    return {f: t.cpu().numpy() for f, t in fields.items()}


def _pack(fields: dict) -> torch.Tensor:
    """The plain version's fields as the kernel packs them (ss.layout):
    the floats' bits, active as 0 or 1."""
    parts = []
    for f in ss.FIELDS:
        t = fields[f]
        t = t.to(torch.int32) if t.dtype == torch.bool else t
        parts.append(t.contiguous().view(torch.int32).reshape(-1))
    return torch.cat(parts)


_LIBS = {"chunked": _build.library, "gather": _build.gather_library}


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_numpy_loop_bit_for_bit(name):
    case = CASES[name]
    rows = _rows(case)
    want = _numpy_slots(*rows, case["off"], case["N"], case["prompt"])
    _assert_same(_host(_plain(case, rows)), want)


def test_numpy_loop_sees_the_edge_cases():
    """The cases hold what they are for: -0.0 slot sums, .5 rem steps,
    dropped and never-valid channels, a head slot of padding."""
    case = CASES["e1b"]
    rows = _rows(case)
    out = _numpy_slots(*rows, case["off"], case["N"], case["prompt"])
    assert np.any(np.signbit(out["mean_i"]) & (out["mean_i"] == 0))
    case = CASES["gps_drop"]
    rows = _rows(case)
    out = _numpy_slots(*rows, case["off"], case["N"], case["prompt"])
    rem = rows[0][:, O_REM_CODE]
    assert np.any(np.abs(np.diff(rem, axis=0)) % 1.0 == 0.5)
    assert out["n_valid"].tolist() == [1008, 1008, 500, 1008, 1008, 0,
                                       1008, 1]
    assert out["active"].tolist() == [True, True, False, True, True, False,
                                      True, False]
    assert out["vcount"][-1].max() < 20 and out["vcount"][1].min() == 0


@pytest.mark.parametrize("name", ["gps_off1", "e1b", "gps_drop"])
def test_pack_unpack_and_the_cpu_wrapper(name):
    case = CASES[name]
    rows = _rows(case, seed=1)
    fields = _plain(case, rows)
    S, C = ss.n_slots(case["cap"], case["N"]), case["C"]
    buf = _pack(fields)
    assert buf.numel() == ss.layout(S, C)["total"]
    got = ss.unpack(buf.numpy(), S, C)
    _assert_same(got, _host(fields))
    # copies: the buffer can be reused under the caller's arrays
    buf.zero_()
    _assert_same(got, _host(fields))
    # the engine's CPU path: the plain version's fields, no launch
    eng = types.SimpleNamespace(
        cfg=types.SimpleNamespace(prompt_index=case["prompt"]))
    before = ss.launches
    out = TrackingEngine._symbol_outputs(eng, *_tensors(rows, "cpu"),
                                         case["off"], case["N"])
    assert ss.launches == before
    _assert_same(out._asdict(), _host(fields))


def test_params_hold_offsets_and_refuse_too_many_channels():
    p = ss.sym_params(1008, 8, 20, 3, 1, np.arange(1, 9))
    assert (p.cap, p.C, p.S, p.N, p.K, p.prompt) == (1008, 8, 52, 20, 3, 1)
    assert list(p.off[:8]) == list(range(1, 9))
    assert p.scale == float(np.float32(1.0 / 20))
    big = ss.sym_params(1008, ss.SYM_MAX_C, 20, 3, 1,
                        np.arange(ss.SYM_MAX_C) % 20 + 1)
    assert list(big.off) == list(np.arange(ss.SYM_MAX_C) % 20 + 1)
    with pytest.raises(ValueError, match=f"1 to {ss.SYM_MAX_C} channels"):
        ss.sym_params(1008, ss.SYM_MAX_C + 1, 20, 3, 1,
                      np.ones(ss.SYM_MAX_C + 1))
    with pytest.raises(ValueError, match="offsets for"):
        ss.sym_params(1008, 8, 20, 3, 1, np.ones(7))


def test_cuda_wrapper_refuses_cpu_rows():
    case = CASES["gps_off1"]
    before = ss.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ss.symbol_slots_cuda(*_tensors(_rows(case), "cpu"), case["off"],
                             case["N"], case["prompt"], lib=None)
    assert ss.launches == before


def test_source_constants_match():
    src = (pathlib.Path(ss.__file__).parent.parent / "csrc"
           / "symbol_slots.cuh").read_text()
    assert f"#define SYM_MAX_C {ss.SYM_MAX_C}" in src
    assert f"sizeof(SymParams) == {ctypes.sizeof(ss.SymParams)}" in src
    assert (f"offsetof(SymParams, off) == "
            f"{ss.SymParams.off.offset}") in src
    order = src[src.index("SYM_START = 0"):src.index("SYM_FIELDS\n")]
    assert order.count("SYM_") == ss.SYM_FIELDS


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("walk", ["chunked", "gather"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_gpu(name, walk):
    dev = _card()
    case = CASES[name]
    rows = _rows(case, seed=7)
    t = _tensors(rows, dev)
    want = _host(ss.symbol_slots_plain(*t, np.array(case["off"]),
                                       case["N"], case["prompt"]))
    before = ss.launches
    buf = ss.symbol_slots_cuda(*t, case["off"], case["N"], case["prompt"],
                               _LIBS[walk]())
    assert ss.launches == before + 1
    S = ss.n_slots(case["cap"], case["N"])
    _assert_same(ss.unpack(buf.cpu().numpy(), S, case["C"]), want)


def _walk_rows(eng, st, x, span):
    n_epochs = eng._check_capture(x, span)
    _, out_f, out_i, out_corr = eng._run_capture(x, st, span, n_epochs)
    return out_f, out_i, out_corr


@pytest.mark.gpu
def test_engine_symbols_match_plain_on_real_walks():
    dev = _card()
    # GPS, the chunked walk: 2 channels at 2 Msps over 0.5 s
    sats = [SatParams(prn=3, doppler_hz=1200.0, delay_chips=300.5,
                      cn0_dbhz=48.0),
            SatParams(prn=8, doppler_hz=-2500.0, delay_chips=700.25,
                      cn0_dbhz=48.0)]
    fs = 2.0e6
    x = torch.from_numpy(generate_baseband(
        GPS_L1_CA, sats, {s.prn: gps_l1ca_code(s.prn) for s in sats}, fs,
        0.6)).to(dev)
    eng = TrackingEngine(TrackConfig(
        fs_hz=fs, code_length_chips=1023, chip_rate_chips_s=1.023e6,
        carrier_freq_hz=GPS_L1_CA.carrier_freq_hz, n_channels=2,
        chunk_epochs=16), np.stack([gps_l1ca_code(s.prn) for s in sats]),
        device=dev)
    st = eng.init_state()
    for ch, s in enumerate(sats):
        st = eng.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * fs,
                                  s.doppler_hz, 0, 0)
    # E1B, the gather walk: 2 channels at 4 Msps over 0.2 s of noise
    fs_e = 4.0e6
    eng_e = TrackingEngine(TrackConfig(
        fs_hz=fs_e, code_length_chips=4092, chip_rate_chips_s=1.023e6,
        carrier_freq_hz=GPS_L1_CA.carrier_freq_hz, n_channels=2,
        code_samples_per_chip=2, veml=True, correlator="gather"),
        np.stack([galileo_e1_sinboc11(galileo_e1b_code(p)) for p in (1, 2)]),
        device=dev)
    st_e = eng_e.init_state()
    for ch in range(2):
        st_e = eng_e.activate_channel(st_e, ch, ch, 100.0 + 900 * ch, 500.0,
                                      0, 0)
    g = torch.Generator(device=dev).manual_seed(5)
    x_e = torch.complex(
        torch.randn(int(fs_e * 0.25), device=dev, generator=g),
        torch.randn(int(fs_e * 0.25), device=dev, generator=g))
    for e, s, xx, span, N, off in (
            (eng, st, x, int(fs * 0.5), 20, np.array([5, 9])),
            (eng_e, st_e, x_e, int(fs_e * 0.2), 1, np.array([1, 1]))):
        rows = _walk_rows(e, s, xx, span)
        want = _host(ss.symbol_slots_plain(
            *rows, s.rem_code_phase_samples, off, N, e.cfg.prompt_index))
        before = ss.launches
        got = e._symbol_outputs(*rows, s.rem_code_phase_samples, off, N)
        assert ss.launches == before + 1
        _assert_same(got._asdict(), want)
        assert want["n_valid"].min() > 0
