"""The one-epoch multicorrelator kernel's arithmetic and launch block on
the CPU (ops/multicorrelator.py, csrc/multicorrelate.cuh).

The kernel splits each channel's samples into contiguous slices over a
cluster of G CTAs (G from the row length N, `mc_geometry`), each thread
sums its strided samples of its CTA's slice in order, the warps reduce by
shuffles, warp 0 sums the warps, and rank 0 adds the CTAs' sums in rank
order.  `kernel_order` is that summation order in float32 over the plain
version's per-sample terms; it is held to the JAX package's
`multicorrelate` (gnss_sdr_1_tpu/ops/multicorrelator.py:36, compiled) at
1e-5 of the taps' scale, the bar of tests/test_torch_kf.py::
test_multicorrelate_matches_jax, at the TCP connector's rates (2,046 and
4,094 samples an epoch), K = 3 and 5, orders 2 and 3, n_valid < N, a
carrier phase near 1e5 rad, and C = 1 and 12.  The parameter block's
ctypes mirror is held to the offsets the header states, the host-side
packing to what the kernel reads, and the wrapper's refusals are checked.
The kernel itself runs only on the card (chip_smoke.py phase 2c)."""

import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu.codes import gps_l1ca_code
from gnss_sdr_1_tpu.ops.multicorrelator import multicorrelate_batch as jmcb
from gnss_sdr_1_tpu_torch.ops import multicorrelator as mc
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HEADER = (pathlib.Path(__file__).resolve().parent.parent
          / "gnss_sdr_1_tpu_torch" / "csrc" / "multicorrelate.cuh")
SHIFTS = {3: (-0.5, 0.0, 0.5), 5: (-1.0, -0.5, 0.0, 0.5, 1.0)}
PRNS = (1, 7, 22, 3, 14, 9, 30, 17, 5, 11, 26, 2)
# the JAX package's multicorrelator compiled, as its engines run it: XLA
# fuses the phase's multiply-add into one rounding, as the port does; run
# op by op, the phase near 1e5 rad (a float32 unit is 7.8e-3 rad there)
# rounds apart at some samples and the taps part by ~5e-5 of their scale
JMCB = jax.jit(jmcb)


def _tree(v):
    """Lane 0's sum of a warp's 32 values (the last axis) after the
    shuffle tree of gather_corr.cuh warp_sum: offsets 16, 8, 4, 2, 1."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v[..., :o] = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _ordered_sum(terms, G, S):
    """The kernel's sum of float32 per-sample terms [..., N]: CTA g's
    slice [g S, g S + S), thread t's samples t, t + T, ... in order, the
    warp tree, warp 0's tree over the warps, the CTAs in rank order."""
    T = mc.MC_THREADS
    lead = terms.shape[:-1]
    J = -(-S // T)
    pad = np.zeros(lead + (G * J * T,), np.float32)
    v = np.zeros(lead + (G * S,), np.float32)
    v[..., :terms.shape[-1]] = terms
    pad.reshape(lead + (G, J * T))[..., :S] = v.reshape(lead + (G, S))
    pad = pad.reshape(lead + (G, J, T))
    acc = np.zeros(lead + (G, T), np.float32)
    for j in range(J):
        acc = acc + pad[..., j, :]
    warps = _tree(acc.reshape(lead + (G, mc.MC_WARPS, 32)))
    lanes = np.zeros(lead + (G, 32), np.float32)
    lanes[..., :mc.MC_WARPS] = warps
    cta = _tree(lanes)
    out = cta[..., 0]
    for g in range(1, G):
        out = out + cta[..., g]
    return out


def kernel_order(x, codes, shifts, step, rem, cp, cs, cr, nv):
    """The plain version's per-sample terms summed in the kernel's order:
    complex64 [C, K]."""
    C, N = x.shape
    G, S = mc.mc_geometry(N)
    xt = torch.as_tensor(x)
    n = torch.arange(N, dtype=torch.float32)
    f = [torch.as_tensor(np.asarray(v, np.float32))[:, None]
         for v in (step, rem, cp, cs, cr)]
    phase = torch.addcmul(torch.addcmul(f[2], f[3], n), 0.5 * f[4] * n, n)
    wiped = xt * torch.complex(torch.cos(phase), -torch.sin(phase))
    wiped = torch.where(n < torch.as_tensor(nv, dtype=torch.float32)[:, None],
                        wiped, torch.zeros((), dtype=wiped.dtype))
    idx = mc._code_indices(n, f[0][:, 0], torch.tensor(shifts,
                                                       dtype=torch.float32),
                           f[1][:, 0], codes.shape[-1])
    chips = torch.gather(torch.as_tensor(codes)[:, None, :].expand(
        C, len(shifts), codes.shape[-1]), -1, idx).numpy()
    wr = wiped.real.numpy()[:, None, :]
    wi = wiped.imag.numpy()[:, None, :]
    re = _ordered_sum(np.where(chips > 0, wr, -wr).astype(np.float32), G, S)
    im = _ordered_sum(np.where(chips > 0, wi, -wi).astype(np.float32), G, S)
    return (re + 1j * im).astype(np.complex64)


def _case(N, K, C, order, phase, seed):
    rng = np.random.default_rng(seed)
    x = ((rng.standard_normal((C, N)) + 1j * rng.standard_normal((C, N)))
         * 30.0).astype(np.complex64)
    codes = np.stack([gps_l1ca_code(PRNS[c]) for c in range(C)]).astype(
        np.float32)
    step = (1.023e6 / (N / 1e-3)) * (1 + rng.uniform(-1e-6, 1e-6, C))
    rem = rng.uniform(-0.3, 0.9, C)
    cp = rng.uniform(0, 6.2, C) + (1e5 if phase == "1e5" else 0.0)
    cs = rng.uniform(-0.005, 0.005, C)
    cr = np.full(C, 3e-9 if order == 3 else 0.0)
    nv = N - rng.integers(1, 60, C)
    args = [np.asarray(a, np.float32) for a in (step, rem, cp, cs, cr, nv)]
    return x, codes, np.asarray(SHIFTS[K], np.float32), args


@pytest.mark.parametrize("C", [1, 12])
@pytest.mark.parametrize("phase", ["small", "1e5"])
@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("N", [2046, 4094])
def test_kernel_order_matches_jax(N, K, order, phase, C):
    x, codes, shifts, args = _case(N, K, C, order, phase, N + 7 * K + C)
    want = np.asarray(JMCB(jnp.asarray(x), jnp.asarray(codes),
                           jnp.asarray(shifts), *map(jnp.asarray, args)))
    got = kernel_order(x, codes, tuple(shifts), *args)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert (args[5] < N).all()
    # the plain version, summed in its own order, to the same bar
    plain = mc.multicorrelate(
        torch.as_tensor(x), torch.as_tensor(codes), torch.as_tensor(shifts),
        *(torch.as_tensor(a) for a in args[:4]),
        carr_rate_rad=torch.as_tensor(args[4]),
        n_valid=torch.as_tensor(args[5])).numpy()
    assert np.abs(got - plain).max() <= 1e-5 * scale


def test_ordered_sum_is_the_kernel_tree():
    """The twin's order on values where float32 order shows: 1 + 2^-24 ...
    sums differ by order, and the tree's pairs are the shuffle's."""
    v = np.zeros(64, np.float32)
    v[0], v[16] = 1.0, 2.0 ** -24
    v[8], v[24] = 2.0 ** -24, 2.0 ** -24
    # lane 0: ((v0 + v16) + (v8 + v24)) = (1 + 2^-24 rounds to 1) + 2^-23
    assert _tree(v[None, :32])[0] == np.float32(1.0 + 2.0 ** -23)
    terms = np.arange(1, 4095, dtype=np.float32)[None]
    G, S = mc.mc_geometry(4094)
    assert _ordered_sum(terms, G, S)[0] == terms.sum(dtype=np.float64)


def test_geometry_from_the_row_length():
    assert mc.mc_geometry(4094) == (8, 512)
    assert mc.mc_geometry(2046) == (4, 512)
    assert mc.mc_geometry(100) == (1, 100)
    assert mc.mc_geometry(16368) == (16, 1023)
    for N in (1, 511, 512, 513, 4093, 8191, 8192, 8193, 40968, 60050):
        G, S = mc.mc_geometry(N)
        assert 1 <= G <= mc.MC_MAX_CLUSTER
        assert S * G >= N > S * (G - 1)      # every CTA holds samples
    lay = mc.mc_layout(5, 16, 10230, 3754)
    offs = [lay[k] for k in ("bar", "part", "cl", "bits", "buf", "total")]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    assert lay["total"] - lay["buf"] >= 8 * (3754 + 1)
    assert lay["buf"] - lay["bits"] >= 4 * (10230 // 32 + 1)


def _header_ints(pattern):
    return {m.group(1): int(m.group(2))
            for m in re.finditer(pattern, HEADER.read_text())}


def test_params_mirror_the_header():
    offsets = _header_ints(r"offsetof\(McParams, (\w+)\) == (\d+)")
    assert set(offsets) == {"dev", "stride", "C", "probe", "shifts", "val",
                            "n_valid"}
    for name, off in offsets.items():
        assert getattr(mc.McParams, name).offset == off, name
    size = _header_ints(r"sizeof\((McParams)\) == (\d+)")["McParams"]
    assert ctypes.sizeof(mc.McParams) == size
    defines = _header_ints(r"#define (MC_\w+) (\d+)")
    assert defines["MC_THREADS"] == mc.MC_THREADS
    assert defines["MC_MAX_K"] == mc.MC_MAX_K
    assert defines["MC_MAX_C"] == mc.MC_MAX_C
    assert defines["MC_MAX_CLUSTER"] == mc.MC_MAX_CLUSTER
    assert defines["MC_ARGS"] == len(mc.MC_ARGS)
    assert defines["MC_CR"] == mc.MC_CR
    assert defines["MC_STAGE_POINTS"] == mc.STAGE_POINTS
    for name in ("START", "ISSUED", "PACKED", "READY", "CORR", "CTA", "DONE",
                 "SAMPLES"):
        assert defines[f"MC_T_{name}"] == getattr(mc, f"T_{name}")
    for name in ("SINCOS", "TAPS", "F32"):
        assert defines[f"MC_PROBE_{name}"] == getattr(mc, f"PROBE_{name}")


CARD = torch.device("cuda")


def test_python_numbers_go_by_value():
    p, keep = mc.pack_params(1, 2046, 1023, [-0.5, 0.0, 0.5],
                             (0.1 + 1e-9, -0.3, 1e5 + 0.123, 0.0025, 0.0,
                              None), CARD)
    assert keep == [] and list(p.dev) == [None] * 6
    assert (p.C, p.K, p.N, p.L, p.order, p.probe) == (1, 3, 2046, 1023, 2,
                                                      0)
    assert (p.G, p.slice) == mc.mc_geometry(2046)
    assert p.smem == mc.mc_layout(3, p.G, 1023, p.slice)["total"]
    for a, v in enumerate((0.1 + 1e-9, -0.3, 1e5 + 0.123, 0.0025, 0.0)):
        assert p.val[a][0] == float(np.float32(v))
    assert list(p.shifts)[:3] == [-0.5, 0.0, 0.5]
    assert p.n_valid[0] == 2046
    # a non-zero rate takes the order-3 instance; n_valid counts n < it
    p, _ = mc.pack_params(3, 4094, 1023, [-0.5, 0.0, 0.5],
                          (0.25, [0.1, 0.2, 0.3], 1.0, 0.0, 3e-9,
                           [4000.5, -3, 9999]), CARD)
    assert p.order == 3
    assert [p.val[1][c] for c in range(3)] == [
        float(np.float32(v)) for v in (0.1, 0.2, 0.3)]
    assert [p.val[0][c] for c in range(3)] == [0.25] * 3
    assert list(p.n_valid)[:3] == [4001, 0, 4094]
    # numpy arrays and tensors off the card are host values too
    p, keep = mc.pack_params(2, 100, 1023, np.float32([-0.5, 0, 0.5]),
                             (np.float32([0.5, 0.25]), torch.tensor(0.1),
                              0, 1, np.zeros(2), torch.tensor([90, 80])),
                             CARD)
    assert keep == [] and p.order == 2 and list(p.n_valid)[:2] == [90, 80]
    assert [p.val[1][c] for c in range(2)] == [float(np.float32(0.1))] * 2


def test_tensors_on_the_device_go_by_pointer():
    # the samples' device stands in for the card: its tensors go by pointer
    dev = torch.device("cpu")
    C = 4
    step = torch.full((C,), 0.25)
    rem = torch.zeros(2 * C)[::2]                  # a strided view
    cp = torch.tensor(1.5)                          # one value for all
    cr = torch.zeros(C)                             # zeros, still order 3
    nv = torch.tensor([4000.5, 12.0, 0.0, 5000.0])  # float: ceil, int32
    p, keep = mc.pack_params(C, 4094, 1023, [-0.5, 0.0, 0.5],
                             (step, rem, cp, 0.001, cr, nv), dev)
    assert p.order == 3
    assert p.dev[0] == step.data_ptr() and p.stride[0] == 1
    assert p.dev[1] == rem.data_ptr() and p.stride[1] == 2
    assert p.dev[2] == cp.data_ptr() and p.stride[2] == 0
    assert p.dev[3] is None and p.val[3][C - 1] == float(np.float32(0.001))
    assert p.dev[4] == cr.data_ptr()
    converted = [t for t in keep if t.dtype == torch.int32]
    assert len(converted) == 1 and p.dev[5] == converted[0].data_ptr()
    assert converted[0].tolist() == [4001, 12, 0, 5000]
    assert p.stride[5] == 1
    # above MC_MAX_C channels only pointers carry per-channel values
    C = mc.MC_MAX_C + 1
    args = tuple(torch.zeros(C) for _ in range(5)) + (
        torch.full((C,), 10, dtype=torch.int32),)
    p, _ = mc.pack_params(C, 100, 1023, [-0.5, 0.0, 0.5], args, dev)
    assert all(v is not None for v in p.dev)


def test_refusals():
    shifts = [-0.5, 0.0, 0.5]
    with pytest.raises(ValueError, match="K=3 or 5"):
        mc.pack_params(1, 100, 1023, [-0.5, 0.5], (0,) * 5 + (None,), CARD)
    with pytest.raises(ValueError, match="at most 32 channels"):
        mc.pack_params(mc.MC_MAX_C + 1, 100, 1023, shifts,
                       (0,) * 5 + (None,), CARD)
    with pytest.raises(ValueError, match="one per channel"):
        mc.pack_params(3, 100, 1023, shifts, (0, [1, 2], 0, 0, 0, None),
                       CARD)
    with pytest.raises(ValueError, match="one per channel"):
        mc.pack_params(3, 100, 1023, shifts,
                       (torch.zeros(2), 0, 0, 0, 0, None),
                       torch.device("cpu"))
    x = torch.zeros((1, 100), dtype=torch.complex64)
    code = torch.ones((1, 1023))
    with pytest.raises(ValueError, match="CUDA tensors"):
        mc.multicorrelate_cuda(x, code, shifts, 0.5, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mc.multicorrelate_stages(x, code, shifts, 0.5, 0.0, 0.0, 0.0)
    before = mc.launches
    # on the CPU `correlate` is the plain version and counts nothing
    out = mc.correlate(x[0], code[0], shifts, 0.5, 0.0, 0.0, 0.0)
    assert out.shape == (3,) and mc.launches == before


def test_stage_split_reads_a_timeline():
    tl = np.zeros((8, mc.STAGE_POINTS), np.int64)
    base = np.arange(8)[:, None] * 10_000          # each SM's own clock
    marks = np.array([0, 100, 400, 900, 2900, 3100, 4100])
    tl[:, :7] = base + marks
    tl[:, mc.T_SAMPLES] = 2
    tl[7, mc.T_SAMPLES] = 0                         # an idle last CTA
    tl[7, mc.T_CORR] = tl[7, mc.T_READY]
    r = mc.stage_split(tl, ms=4100 / 1500 * 1e-3)
    assert r["ctas"] == 8 and r["ordered"]
    assert r["cycles"]["issue"] == 100 and r["cycles"]["pack"] == 300
    assert r["cycles"]["wait"] == 500
    assert r["cycles_per_sample"] == 1000.0
    assert r["samples_thread0"] == 14 / 8
    assert abs(r["mhz"] - 1500.0) < 1e-9
