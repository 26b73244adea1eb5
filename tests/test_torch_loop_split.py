"""The loop closure split around the correlation (ops/track_chain.py,
csrc/loop_close.cuh): `loop_close_plain` is its state-only part
(`loop_pre_plain`, which the gather kernel runs beside its correlation)
and the rest from the taps on (`loop_post_plain`), composed.

- the composition against a snapshot of the closure before the split
  (`tests/data/loop_close_snapshot.json`: the SHA-256 of every output
  array, written by `loop_close_plain` as it stood before the split, from
  the inputs below): every output of every epoch bit for bit, at K = 3
  and 5, PLL orders 2 and 3, with and without the secondary code and its
  data flag, over 40 epochs of random taps from random states, so that the
  wide and narrow modes, the extension boundary, the FLL turn-off, the CN0
  windows, lock fails and dead or finished channels all occur;
- `loop_close_plain` against its parts composed by hand, bit for bit.
"""

import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code, tracking_replica
from gnss_sdr_1_tpu_torch.ops import track_chain as tc
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.loop_filter import fll_pll_coefficients
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SNAPSHOT = pathlib.Path(__file__).parent / "data" / "loop_close_snapshot.json"
C = 48
EPOCHS = 40
# (name, K, PLL order, sec_data, secondary code length)
CASES = (("k3_o3", 3, 3, False, 1), ("k3_o2_sec", 3, 2, True, 20),
         ("k3_o3_sec_nodata", 3, 3, False, 10), ("k5_o3_sec", 5, 3, False, 20),
         ("k5_o2_data", 5, 2, True, 1))


def chain_spec(K, order, sec_data, sec_len):
    """The chain's loop constants of a GPS (K = 3) or Galileo E1B (K = 5,
    VEML) engine at 4 Msps, at the PLL order, secondary-code length and
    data flag asked for, extension and CN0 windows short enough for 40
    epochs to cross them."""
    if K == 5:
        kw = dict(fs_hz=4.0e6, code_length_chips=4092,
                  chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                  code_samples_per_chip=2, veml=True,
                  early_late_space_chips=0.15,
                  very_early_late_space_chips=0.6)
        codes = np.stack([tracking_replica("1B", p)[0] for p in (1, 2)])
    else:
        kw = dict(fs_hz=4.092e6, code_length_chips=1023,
                  chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6)
        codes = np.stack([gps_l1ca_code(p) for p in (1, 2)])
    cfg = TrackConfig(n_channels=C, chunk_epochs=8, cn0_samples=6,
                      extend_correlation_symbols=4, fll_narrow_windows=3,
                      pull_in_time_s=0.004 * K, **kw)
    spec = TrackingEngine(cfg, codes, device="cpu").chain_spec
    spec = dataclasses.replace(spec, sec_data=sec_data, sec_len=sec_len)
    if order == 2:
        w2 = fll_pll_coefficients(35.0, 25.0, 2)
        n2 = fll_pll_coefficients(8.0, 12.0, 2)

        def coef(c):
            return (c.w0p, c.w0p2, c.w0p3, c.w0f, c.w0f2, c.a2, c.a3, c.b3)

        spec = dataclasses.replace(spec, order=2, wide=coef(w2),
                                   narrow=coef(n2))
    return spec


def closure_inputs(spec, seed):
    """Random entering state rows of C channels and EPOCHS epochs of random
    taps around a correlation peak (some exactly zero), and the secondary
    rows: (fst, ist, taps_r [EPOCHS, K, C], taps_i, sec_rows)."""
    rng = np.random.default_rng(seed)
    K = spec.K
    f = np.zeros((tc.n_frows(K), C), np.float32)
    i = np.zeros((tc.N_IROWS, C), np.int32)
    f[tc.F_REM_CODE] = rng.uniform(0, 1, C)
    f[tc.F_DELTA] = rng.uniform(-1, 1, C)
    f[tc.F_DOPPLER] = rng.uniform(-3000, 3000, C)
    f[tc.F_REM_CARR] = rng.uniform(0, 2 * np.pi, C)
    f[tc.F_CARR_W] = rng.uniform(-50, 50, C)
    f[tc.F_CARR_X] = 2 * f[tc.F_DOPPLER] + rng.uniform(-5, 5, C)
    f[tc.F_PREV_R] = rng.uniform(-500, 500, C)
    f[tc.F_PREV_I] = rng.uniform(-500, 500, C)
    f[tc.F_SABSI] = rng.uniform(0, 3000, C)
    f[tc.F_SI2] = rng.uniform(0, 1e6, C)
    f[tc.F_SQ2] = rng.uniform(0, 2e5, C)
    f[tc.F_CN0] = rng.uniform(20, 50, C)
    f[tc.F_ACCH_R] = rng.uniform(-2000, 2000, C) * (rng.uniform(size=C) > 0.2)
    f[tc.F_ACCH_I] = rng.uniform(-500, 500, C)
    f[tc.F_CARR_OFF] = rng.choice([0.0, 562.5e3, -1125e3], C)
    f[tc.F_DLL_IN0:tc.F_DLL_IN0 + 3] = rng.uniform(-0.1, 0.1, (3, C))
    f[tc.F_DLL_OUT0:tc.F_DLL_OUT0 + 3] = rng.uniform(-0.1, 0.1, (3, C))
    f[tc.F_ACC_R0:] = rng.uniform(-1000, 1000, (2 * K, C))
    start = rng.integers(0, 10 ** 6, C)
    i[tc.I_ACTIVE] = rng.uniform(size=C) > 0.1
    i[tc.I_START] = start
    i[tc.I_CURLEN] = 4092 + rng.integers(-1, 2, C)
    i[tc.I_PUSH] = rng.integers(0, 12, C)
    i[tc.I_LOCKFAIL] = rng.integers(0, 4, C)
    i[tc.I_EPOCHS] = rng.integers(0, 12, C)
    i[tc.I_FLL_ON] = rng.uniform(size=C) > 0.4
    i[tc.I_MODE] = rng.integers(0, 3, C)
    i[tc.I_EXTCNT] = rng.integers(0, spec.ext_n, C)
    i[tc.I_SEC_ON] = rng.uniform(size=C) > 0.5
    i[tc.I_SEC_IDX] = rng.integers(0, spec.sec_len, C)
    # most channels run past the 40 epochs, some stop on the way
    i[tc.I_LIMIT] = start + 4092 * rng.integers(-1, 80, C)
    peak = rng.uniform(50, 800, C) * rng.choice([-1.0, 1.0], C)
    shape = np.exp(-np.abs(np.arange(K) - K // 2))[None, :, None]
    taps_r = (shape * peak[None, None, :]
              + rng.normal(0, 60, (EPOCHS, K, C))).astype(np.float32)
    taps_i = (0.2 * shape * peak[None, None, :]
              + rng.normal(0, 60, (EPOCHS, K, C))).astype(np.float32)
    zero = rng.uniform(size=(EPOCHS, C)) < 0.05
    taps_r[:, K // 2][zero] = 0.0
    sec = rng.choice([-1.0, 1.0], (spec.sec_len, C)).astype(np.float32)
    return f, i, taps_r, taps_i, sec


def run_closure(spec, close, seed):
    """EPOCHS epochs of `close` (loop_close_plain's signature) carrying the
    state: every output stacked, as numpy arrays keyed by name."""
    f, i, taps_r, taps_i, sec = (torch.as_tensor(a)
                                 for a in closure_inputs(spec, seed))
    consts = tc.loop_consts_plain(spec, i)
    outs = {k: [] for k in ("f", "i", "out_f", "out_i", "out_corr",
                            "valid")}
    for e in range(EPOCHS):
        res = close(spec, consts, f, i, list(taps_r[e]), list(taps_i[e]),
                    sec)
        f, i = res[0], res[1]
        for k, v in zip(outs, res):
            outs[k].append(v.numpy())
    return {k: np.stack(v) for k, v in outs.items()}


def digest(a) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), b.view(np.int32))
    return np.array_equal(a, b)


@pytest.mark.parametrize("name, K, order, sec_data, sec_len", CASES)
def test_composition_matches_the_closure_before_the_split(name, K, order,
                                                          sec_data, sec_len):
    spec = chain_spec(K, order, sec_data, sec_len)
    got = run_closure(spec, tc.loop_close_plain, seed=K * 100 + order)
    snap = json.loads(SNAPSHOT.read_text())
    for k, v in got.items():
        assert digest(v) == snap[f"{name}/{k}"], k
    # the states the 40 epochs pass through
    ist = got["i"]
    assert ist[:, tc.I_MODE].min() == 0 and ist[:, tc.I_MODE].max() == 2
    assert got["valid"].any() and not got["valid"].all()
    assert (got["out_f"][:, tc.O_CN0] != 0).any()
    assert (np.diff(ist[:, tc.I_LOCKFAIL], axis=0) != 0).any()
    assert (np.diff(ist[:, tc.I_FLL_ON], axis=0) < 0).any()


@pytest.mark.parametrize("name, K, order, sec_data, sec_len", CASES)
def test_closure_is_its_parts_composed(name, K, order, sec_data, sec_len):
    spec = chain_spec(K, order, sec_data, sec_len)

    def by_parts(spec, consts, f, i, corr_r, corr_i, sec_rows):
        pre = tc.loop_pre_plain(spec, consts, f, i, sec_rows)
        return tc.loop_post_plain(spec, consts, pre, f, i, corr_r, corr_i)

    want = run_closure(spec, tc.loop_close_plain, seed=7 + K)
    got = run_closure(spec, by_parts, seed=7 + K)
    for k in want:
        assert _bits_equal(got[k], want[k]), k
