"""The port's chunk correlator (ops/chunk_corr.py) and capture-level entry
(ops/track_capture.py).

- `chunk_corr_plain` against the JAX package's `_chunk_windows` plus the
  `einsum` lag correlation (engine with correlator='mxu', on the CPU), on
  the same capture and state: lag windows at atol 1e-4 of max|z| (the two
  sum the products in another order), slice origins and step0 exact.
- The Toeplitz replica-row table against the full bank `rep_rows_np`, bit
  for bit.
- The kernel's split-K geometry (a cluster of CTAs per channel, each
  walking its share of the samples in tiles) keeps every shared-memory
  index in range and fits the card's shared memory and largest cluster at
  every shape chip_smoke.py checks; the choice of cluster from the card's
  occupancy; the mma fragment maps; the TF32 rounding and split; every
  signal's replica table classed exact in TF32 (two passes); the kernel's
  product emulated in plain torch ops through its fragment index maps and
  TF32 passes against the plain correlator (atol 1e-4 of max|z|: the
  sums run in another order and TF32 leaves ~2^-22 of each product), at
  GPS L1 C/A and Galileo E1 shapes.
- The build hash covers the headers the sources include.
- On a GPU: the CUDA correlator against its plain version (lag windows at
  1e-4 of max|z|; slice origins and step0 bit for bit against the plain
  version on the CPU: on CUDA tensors torch divides by a Python scalar as
  a multiply by the float reciprocal, the kernel divides), and the
  capture-level entry (both kernels for several chunks in one call) against
  the plain chunk loop on the CPU, int rows exact.  They skip without a
  GPU and import nothing of JAX, so on a GPU machine without JAX they run as
      python -m pytest --noconftest -m gpu tests/test_torch_chunk_corr.py"""

import numpy as np
import pytest
import torch

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code, tracking_replica
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.ops import _build
from gnss_sdr_1_tpu_torch.ops import chunk_corr as cc
from gnss_sdr_1_tpu_torch.ops import track_capture as tcap
from gnss_sdr_1_tpu_torch.ops import track_chain as tc
from gnss_sdr_1_tpu_torch.ops.cluster_walk import SMEM_MAX
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 4.092e6
C = 4
E = 8
KW = dict(fs_hz=FS, code_length_chips=1023, chip_rate_chips_s=1.023e6,
          carrier_freq_hz=1575.42e6, n_channels=C, chunk_epochs=E)
HEAD_S = 0.02


def _capture():
    rng = np.random.default_rng(33)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                      delay_chips=float(rng.uniform(0, 1023)), cn0_dbhz=45.0)
            for p in range(1, C + 1)]
    codes = np.stack([gps_l1ca_code(p) for p in range(1, C + 1)])
    x = generate_baseband(GPS_L1_CA, sats, {p: codes[p - 1]
                                            for p in range(1, C + 1)},
                          FS, 0.05, noise=True)
    return sats, codes, x


@pytest.fixture(scope="module")
def capture():
    return _capture()


def _port_rows(et, state):
    """The correlator's row inputs for a port TrackState."""
    fst, ist = et._pack_rows(state, 10 ** 6)
    return fst, ist, state.prn_slot.to(torch.int32)


@pytest.fixture(scope="module")
def port_tracked(capture):
    """The port's engine on the CPU after HEAD_S of its own tracking, with
    the rest of the capture padded for chunks."""
    sats, codes, x = capture
    et = TrackingEngine(TrackConfig(**KW), codes, device="cpu")
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * FS,
                                 s.doppler_hz, 0, 0)
    head = int(FS * HEAD_S)
    st, _ = et.track_capture(torch.from_numpy(x), st, head)
    seg = et._pad_for_chunks(torch.from_numpy(x[head:]))
    return et, st, seg


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _leaves(st):
    return {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in st._asdict().items()}


@pytest.mark.parametrize("tracked", [False, True],
                         ids=["activated", "mid_track"])
def test_chunk_corr_plain_matches_jax_windows_einsum(capture, tracked):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from gnss_sdr_1_tpu.track import TrackConfig as JTrackConfig
    from gnss_sdr_1_tpu.track import TrackingEngine as JEngine
    from gnss_sdr_1_tpu.utils.planar import to_planar

    sats, codes, x = capture
    ej = JEngine(JTrackConfig(correlator="mxu", **KW), codes)
    st = ej.init_state()
    for ch, s in enumerate(sats):
        st = ej.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * FS,
                                 s.doppler_hz, 0, 0)
    if tracked:
        head = int(FS * HEAD_S)
        st, _ = ej.track_capture(jnp.asarray(to_planar(x)), st, head)
        x = x[head:]
    samples_p = ej._pad_for_chunks(jnp.asarray(to_planar(x)))
    wiped, s_reg_j, _, _, step0_j = ej._chunk_windows(samples_p, st)
    rep = ej._rep_rows[st.prn_slot]
    zr_j = np.asarray(jnp.einsum("cen,cln->cel", wiped.real, rep,
                                 preferred_element_type=jnp.float32))
    zi_j = np.asarray(jnp.einsum("cen,cln->cel", wiped.imag, rep,
                                 preferred_element_type=jnp.float32))

    et = TrackingEngine(TrackConfig(**KW), codes, device="cpu")
    fst, ist, slot = _port_rows(et, state_from_numpy(_leaves(st), "cpu"))
    samples = et._pad_for_chunks(torch.from_numpy(x))
    assert samples.shape[0] == samples_p.shape[0]
    zr, zi, s_reg, step0 = cc.chunk_corr(et.corr_spec, samples, et._rows,
                                         slot, fst, ist)
    np.testing.assert_array_equal(s_reg.numpy(), np.asarray(s_reg_j))
    np.testing.assert_array_equal(step0.numpy(), np.asarray(step0_j))
    scale = max(np.abs(zr_j).max(), np.abs(zi_j).max())
    assert scale > 100.0          # a correlation peak is in the window
    np.testing.assert_allclose(zr.numpy(), zr_j, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(zi.numpy(), zi_j, rtol=0, atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# tables, geometry, build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", [FS, 2.046e6])
def test_replica_rows_bit_identical_to_bank(fs):
    codes = np.stack([gps_l1ca_code(p) for p in (3, 7, 19)])
    et = TrackingEngine(TrackConfig(**dict(KW, fs_hz=fs)), codes,
                        device="cpu")
    spec = et.corr_spec
    assert et._rows.shape == (3, spec.QW) and spec.QW % 4 == 0
    bank = cc.replica_bank(spec, et._rows, torch.arange(3, dtype=torch.int32))
    np.testing.assert_array_equal(bank.transpose(1, 2).numpy(),
                                  et.rep_rows_np)


def _engine_spec(fs, E_, C_, signal="1C"):
    if signal == "1B":
        # Galileo E1B: 4092 chips at 2 samples per chip, 4 ms epochs
        codes = np.stack([tracking_replica("1B", p)[0] for p in range(1, 3)])
        kw = dict(KW, code_length_chips=4092, code_samples_per_chip=2,
                  veml=True, early_late_space_chips=0.15,
                  very_early_late_space_chips=0.6)
    else:
        codes = np.stack([gps_l1ca_code(p) for p in range(1, 3)])
        kw = KW
    cfg = TrackConfig(**dict(kw, fs_hz=fs, chunk_epochs=E_, n_channels=C_))
    return TrackingEngine(cfg, codes, device="cpu").corr_spec


# every shape chip_smoke.py's phase 2 checks the correlator at: (signal,
# rate); the engines as the script builds them
def _chip_smoke_shapes():
    import chip_smoke as cs

    return [("1C", cs.FS), *(("1C", f) for f in cs.CHECK_RATES),
            ("1B", cs.FS_E1), ("1B", cs.E1_TILED_RATE), ("L5", cs.FS_L5),
            ("5X", cs.FS_E5A), ("1G", cs.FS_GLO_HI), ("2S", cs.FS_L2C),
            ("B1", cs.FS_B1I), ("B3", cs.FS_B3I)]


def _check_split(spec, geo):
    """Every index the kernel's CTAs read or write stays in its buffer:
    the cluster covers the window's k-steps, each CTA's tiles its share;
    the A tile (32 rows of a_stride) and the k-groups' partial blocks in
    a_floats, every B index k - n + 71 of a tile in q_floats; the output
    blocks cover 2E rows and LW lags; the layout fits the card's shared
    memory and the cluster its largest (non-portable) size."""
    assert 1 <= geo.G <= cc.MAX_CLUSTER == 16
    assert geo.NK == -(-spec.NW // cc.KSTEP)
    assert geo.G * geo.SK >= geo.NK > (geo.G - 1) * geo.SK - geo.SK
    assert geo.tiles * geo.TK >= geo.SK > (geo.tiles - 1) * geo.TK
    assert geo.a_stride >= cc.KSTEP * geo.TK and geo.a_stride % 8 == 4
    assert geo.a_floats >= cc.BLOCK_ROWS * geo.a_stride
    assert geo.a_floats >= cc.KGROUPS * cc.BLOCK_ROWS * cc.RED_STRIDE
    assert cc.RED_STRIDE >= cc.BLOCK_LAGS and cc.RED_STRIDE % 32 == 24
    # B's q index kk + k - (8 nt + n) + 71 over a tile's k-steps
    hi = cc.KSTEP * (geo.TK - 1) + 7 + cc.BLOCK_LAGS - 1
    assert hi < geo.q_floats and geo.q_floats % 4 == 0
    assert geo.MB * cc.BLOCK_ROWS >= 2 * spec.E
    assert geo.NB * cc.BLOCK_LAGS >= spec.LW
    assert geo.smem == 4 * (2 * spec.E * cc.KSTEP * geo.TK + geo.a_floats
                            + 2 * geo.q_floats + cc.BLOCK_ROWS * cc.BLOCK_LAGS
                            + cc.MAX_CLUSTER + 4 * spec.E)
    # the ranks' rows of the outputs a CTA owns fit their buffer
    assert geo.G * -(-cc.BLOCK_ROWS * cc.BLOCK_LAGS // geo.G) <= (
        cc.BLOCK_ROWS * cc.BLOCK_LAGS + cc.MAX_CLUSTER)
    # two CTAs share an SM
    assert geo.smem <= cc.SMEM_HALF < SMEM_MAX // 2
    assert spec.seg_len == (spec.E - 1) * spec.t0_int + spec.NW


@pytest.mark.parametrize("G", [1, 8, 16])
@pytest.mark.parametrize("signal, fs", _chip_smoke_shapes())
def test_split_k_geometry_at_chip_smoke_shapes(signal, fs, G):
    import chip_smoke as cs

    spec = cs._engine(torch.device("cpu"), fs, signal).corr_spec
    assert spec.E == 16 and spec.LW <= cc.BLOCK_LAGS
    geo = cc.corr_geometry(spec.E, spec.LW, spec.NW, G)
    _check_split(spec, geo)
    assert (geo.MB, geo.NB) == (1, 1)
    # the 4 ms E1 epochs at 8.184 Msps and the 20 ms L2C epochs need
    # several tiles a CTA but in the largest clusters
    if spec.NW > 30000 and G < 16:
        assert geo.tiles > 1


@pytest.mark.parametrize("fs, E_, C_", [(8.184e6, 20, 8), (FS, E, C)])
def test_split_k_geometry_in_blocks(fs, E_, C_):
    """More than 16 epochs or 80 lags: the output in blocks of 32 rows by
    80 lags; fewer than 16 epochs: one block with rows left empty."""
    codes = np.stack([gps_l1ca_code(p) for p in range(1, C_ + 1)])
    cfg = TrackConfig(**dict(KW, fs_hz=fs, chunk_epochs=E_, n_channels=C_))
    spec = TrackingEngine(cfg, codes, device="cpu").corr_spec
    for G in (1, 5, 16):
        geo = cc.corr_geometry(spec.E, spec.LW, spec.NW, G)
        _check_split(spec, geo)
        assert geo.MB == -(-2 * E_ // 32)
        assert geo.NB == (2 if spec.LW > 80 else 1)


def test_split_k_geometry_refuses_what_the_card_cannot_take():
    with pytest.raises(ValueError):
        cc.corr_geometry(16, 68, 4136, 0)
    with pytest.raises(ValueError):
        cc.corr_geometry(16, 68, 4136, 17)
    with pytest.raises(ValueError):       # no tile fits
        cc.corr_geometry(16, 68, 4136, 8, max_smem=50_000)


def test_fit_cluster_takes_the_largest_one_wave():
    spec = _engine_spec(4.092e6, 16, 12)
    # a stand-in card: clusters of G CTAs resident 192 // G at once
    geo = cc.fit_cluster(spec, lambda G, smem: 192 // G)
    assert geo.G == 16 and 192 // 16 >= 12
    geo = cc.fit_cluster(spec, lambda G, smem: 132 // G // 2)
    assert geo.G == 5 and 132 // 5 // 2 >= 12 > 132 // 6 // 2
    # no cluster size fits every channel at once: the largest at all
    geo = cc.fit_cluster(spec, lambda G, smem: 1 if G <= 4 else 0)
    assert geo.G == 4
    with pytest.raises(RuntimeError):
        cc.fit_cluster(spec, lambda G, smem: 0)


# ---------------------------------------------------------------------------
# the kernel's product in plain torch ops: its TF32 rounding, fragment maps
# and passes
# ---------------------------------------------------------------------------


def tf32_round(x):
    """The float32 values rounded to TF32 as `cvt.rna.tf32.f32` rounds
    them: to the nearest value with 10 mantissa bits, ties away from zero
    (the low 13 bits of the float32 pattern cleared)."""
    bits = torch.as_tensor(x, dtype=torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """(hi, lo): x's TF32 value and the TF32 value of what it leaves, the
    kernel's split of a sample (x - hi is exact in float32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# mma.sync.m16n8k8 TF32 fragments (PTX ISA, "Matrix Fragments for
# mma.m16n8k8"): lane = 4 g + t; the kernel loads and stores through the
# same maps (csrc/chunk_corr.cuh frag_*)
def frag_a(lane: int, reg: int) -> tuple[int, int]:
    """(row, col) of A register `reg` (a0..a3) of `lane` in the 16 x 8
    tile."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (reg & 1), t + 4 * (reg >> 1)


def frag_b(lane: int, reg: int) -> tuple[int, int]:
    """(k, n) of B register `reg` (b0, b1) of `lane` in the 8 x 8 tile."""
    g, t = lane >> 2, lane & 3
    return t + 4 * reg, g


def frag_c(lane: int, reg: int) -> tuple[int, int]:
    """(row, col) of accumulator `reg` (c0..c3) of `lane` in the 16 x 8
    tile."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (reg >> 1), 2 * t + (reg & 1)


def _frag_index(fn, regs: int):
    """[32, regs] row and column index tensors of a fragment map."""
    idx = [[fn(lane, r) for r in range(regs)] for lane in range(32)]
    t = torch.tensor(idx)
    return t[..., 0], t[..., 1]


def correlate_mma_emulated(spec, samples, rows, slot, fst, ist, geo,
                           passes=None):
    """The kernel's product in plain torch ops (CPU, float64 sums): each
    CTA's tiles of wiped samples and replica stretch staged as the kernel
    stages them, each warp's k-steps loaded into mma fragments through
    frag_a / frag_b, the TF32 passes (tf32_split; the table split too for
    3 passes), each m16n8k8 product taken as the hardware defines it on the
    fragments, the accumulators stored through frag_c, the k-groups'
    partial blocks summed in order, then the CTAs'.  `passes`: the
    kernel's (spec.passes) by default; 1 takes hi(a) b alone, the product
    the split exists to improve on.  Returns what chunk_corr_plain
    returns."""
    passes = spec.passes if passes is None else passes
    wr, wi, s_reg, step0 = cc.windows_plain(spec, samples, fst, ist)
    C, E, LW, NW = spec.C, spec.E, spec.LW, spec.NW
    f64 = torch.float64
    w = torch.cat([wr, wi], dim=1)                          # [C, 2E, NW]
    rows_all = -(-2 * E // cc.BLOCK_ROWS) * cc.BLOCK_ROWS
    kt_len = cc.KSTEP * geo.NK
    A = torch.zeros((C, rows_all, kt_len + cc.KSTEP * geo.TK),
                    dtype=torch.float32)
    A[:, :2 * E, :NW] = w
    q_rows = rows[slot.long()]                              # [C, QW]
    ar, ac = _frag_index(frag_a, 4)
    bk, bn = _frag_index(frag_b, 2)
    cr, ccol = _frag_index(frag_c, 4)
    z = torch.zeros((C, rows_all, geo.NB * cc.BLOCK_LAGS), dtype=f64)
    for mb in range(geo.MB):
        for nb in range(geo.NB):
            part = torch.zeros((geo.G, C, cc.BLOCK_ROWS, cc.BLOCK_LAGS),
                               dtype=f64)
            for r in range(geo.G):
                k_lo, k_hi = r * geo.SK, min((r + 1) * geo.SK, geo.NK)
                red = torch.zeros((cc.KGROUPS, C, cc.BLOCK_ROWS,
                                   cc.BLOCK_LAGS), dtype=f64)
                for t in range(geo.tiles):
                    ks0 = k_lo + t * geo.TK
                    nks = min(geo.TK, k_hi - ks0)
                    if nks <= 0:
                        continue
                    kt0 = cc.KSTEP * ks0
                    # the tile's replica stretch: q[i] = row[q_base + i]
                    q_base = kt0 + LW - cc.BLOCK_LAGS * (nb + 1)
                    gi = q_base + torch.arange(geo.q_floats)
                    ok = (gi >= 0) & (gi < spec.QW)
                    q = torch.zeros((C, geo.q_floats))
                    q[:, ok] = q_rows[:, gi[ok]]
                    a_tile = A[:, cc.BLOCK_ROWS * mb:cc.BLOCK_ROWS * (mb + 1),
                               kt0:kt0 + cc.KSTEP * geo.TK]
                    for wp in range(cc.KGROUPS):
                        ks = torch.arange(wp, nks, cc.KGROUPS)
                        if len(ks) == 0:
                            continue
                        kk = cc.KSTEP * ks                          # [S]
                        for mt in range(2):
                            # A fragments [C, S, 32, 4] from the tile
                            a = a_tile[:, 16 * mt + ar,
                                       kk[:, None, None] + ac]
                            a_parts = tf32_split(a)
                            for nt in range(cc.BLOCK_LAGS // 8):
                                qi = (kk[:, None, None] + bk - (8 * nt + bn)
                                      + cc.BLOCK_LAGS - 1)
                                b = q[:, qi]                     # [C,S,32,2]
                                if passes == 3:
                                    bh, bl = tf32_split(b)
                                    terms = ((a_parts[1], bh),
                                             (a_parts[0], bh),
                                             (a_parts[0], bl))
                                elif passes == 2:
                                    terms = ((a_parts[1], b), (a_parts[0], b))
                                else:
                                    terms = ((a_parts[0], b),)
                                d = torch.zeros((C, 16, 8), dtype=f64)
                                for af, bf in terms:
                                    # the m16n8k8 product on the fragments
                                    at = torch.zeros((C, len(ks), 16, 8),
                                                     dtype=f64)
                                    at[:, :, ar, ac] = af.double()
                                    bt = torch.zeros((C, len(ks), 8, 8),
                                                     dtype=f64)
                                    bt[:, :, bk, bn] = bf.double()
                                    d += (at @ bt).sum(dim=1)
                                # accumulators out through frag_c
                                dc = d[:, cr, ccol]              # [C, 32, 4]
                                red[wp, :, 16 * mt + cr,
                                    8 * nt + ccol] += dc
                part[r] = red.sum(dim=0)
            z[:, cc.BLOCK_ROWS * mb:cc.BLOCK_ROWS * (mb + 1),
              cc.BLOCK_LAGS * nb:cc.BLOCK_LAGS * (nb + 1)] = part.sum(dim=0)
    z = z[:, :2 * E, :LW].float()
    return z[:, :E].contiguous(), z[:, E:].contiguous(), s_reg, step0


@pytest.mark.parametrize("fn, regs, shape", [
    (frag_a, 4, (16, 8)), (frag_b, 2, (8, 8)), (frag_c, 4, (16, 8))])
def test_fragment_maps_cover_their_tiles_once(fn, regs, shape):
    seen = {fn(lane, r) for lane in range(32) for r in range(regs)}
    assert len(seen) == 32 * regs == shape[0] * shape[1]
    assert all(0 <= i < shape[0] and 0 <= j < shape[1] for i, j in seen)


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, -1.0, 0.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12), 3.14159265, 1e-20],
                     dtype=torch.float32)
    hi, lo = tf32_split(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()
    # nearest, ties away from zero
    assert hi[3] == 1.0 + 2 ** -10 and hi[4] == 1.0
    assert hi[5] == -(1.0 + 2 ** -10)
    assert hi[6] == 3.140625
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs().clamp(min=1e-30))
    assert float(rel.max()) < 2 ** -21
    assert cc.table_passes(np.array([[1.0, -1.0, 0.0]])) == 2
    assert cc.table_passes(np.array([[1.0, 0.5, 0.7]])) == 3


@pytest.mark.parametrize("signal", ["1C", "2S", "L5", "1B", "5X", "1G", "2G",
                                    "B1", "B3"])
def test_every_signal_table_is_classed_as_the_wrapper_classes_it(signal):
    """The engine classes its replica table when it builds it
    (table_passes): every signal's codes (+-1, 0) are exact in TF32, so
    each runs the two-pass instance; a table holding any other value takes
    the three-pass one."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    kw = {"fdma_k": ((1, 0),)} if signal in ("1G", "2G") else {}
    prn = {"5X": 11, "B1": 6, "B3": 6}.get(signal, 1)
    rx = Receiver(ReceiverConfig(signal_id=signal, prn_search=(prn,),
                                 n_channels=1, **kw), device="cpu")
    spec = rx.trk.corr_spec
    assert spec.passes == cc.table_passes(rx.trk._rows.numpy()) == 2
    noisy = rx.trk._rows.numpy() * np.float32(1.0 + 2 ** -12)
    assert cc.table_passes(noisy) == 3


def _emulation_case(et, st, seg, G, passes):
    """The kernel's product emulated through its fragments against the
    plain correlator on a chunk: slice origins and step0 exact, lag
    windows within 1e-4 of max|z|."""
    import dataclasses

    fst, ist, slot = _port_rows(et, st)
    rows = et._rows
    spec = et.corr_spec
    if passes == 3:
        # a table that is not exact in TF32 takes the three-pass product
        rows = rows * np.float32(1.0 + 2 ** -12)
        assert cc.table_passes(rows.numpy()) == 3
    spec = dataclasses.replace(spec, passes=passes)
    geo = cc.corr_geometry(spec.E, spec.LW, spec.NW, G)
    got = correlate_mma_emulated(spec, seg, rows, slot, fst, ist, geo)
    want = cc.chunk_corr_plain(spec, seg, rows, slot, fst, ist)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    np.testing.assert_array_equal(got[3].numpy(), want[3].numpy())
    scale = float(max(want[0].abs().max(), want[1].abs().max()))
    assert scale > 100.0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * scale)
    return geo


@pytest.mark.parametrize("G, passes", [(8, 2), (16, 3)])
def test_mma_emulation_matches_plain_at_gps(port_tracked, G, passes):
    et, st, seg = port_tracked
    geo = _emulation_case(et, st, seg, G, passes)
    assert geo.MB == 1 and 2 * et.corr_spec.E < 32   # rows left empty


@pytest.mark.parametrize("G, passes", [(8, 2), (3, 3)])
def test_mma_emulation_matches_plain_at_e1(e1_activated, G, passes):
    et, st, seg = e1_activated
    geo = _emulation_case(et, st, seg, G, passes)
    assert geo.tiles > 1                   # 16k samples: several tiles


@pytest.mark.parametrize("tracked", ["port_tracked", "e1_activated"],
                         ids=["gps", "e1"])
def test_one_tf32_pass_misses_the_bar(request, tracked):
    """The negative control of the split: on random samples (I and Q
    N(0, 100^2), as chip_smoke.py's phase 2 checks the kernel on) one TF32
    pass, hi(a) b alone, misses the bar of 1e-4 of max|z| that the
    kernel's two passes meet, at the GPS and E1 shapes."""
    et, st, seg = request.getfixturevalue(tracked)
    fst, ist, slot = _port_rows(et, st)
    g = torch.Generator().manual_seed(7)
    noise = torch.view_as_complex(torch.randn((seg.shape[0], 2),
                                              generator=g) * 100.0)
    spec = et.corr_spec
    geo = cc.corr_geometry(spec.E, spec.LW, spec.NW, 8)
    want = cc.chunk_corr_plain(spec, noise, et._rows, slot, fst, ist)
    scale = float(max(want[0].abs().max(), want[1].abs().max()))
    err = {}
    for passes in (1, 2):
        got = correlate_mma_emulated(spec, noise, et._rows, slot, fst, ist,
                                     geo, passes=passes)
        err[passes] = max(float((g_ - w).abs().max())
                          for g_, w in zip(got[:2], want[:2])) / scale
    assert err[2] < 1e-5 < 1e-4 < err[1]


@pytest.fixture(scope="module")
def e1_activated():
    """A Galileo E1 engine at 4 Msps (NW ~ 16k) with 4 channels activated
    at the truth of a synthetic capture, and the capture padded for
    chunks."""
    import dataclasses

    from gnss_sdr_1_tpu_torch.constants import GALILEO_E1B

    rng = np.random.default_rng(9)
    prns = range(1, C + 1)
    sats = [SatParams(prn=p, doppler_hz=float(rng.uniform(-3000, 3000)),
                      delay_chips=float(rng.uniform(0, 8184)), cn0_dbhz=45.0)
            for p in prns]
    codes = np.stack([tracking_replica("1B", p)[0] for p in prns])
    spec = dataclasses.replace(GALILEO_E1B, code_rate_chips_s=2.046e6,
                               code_length_chips=8184, bit_rate_bps=250.0)
    fs = 4.0e6
    x = generate_baseband(spec, sats, {p: codes[p - 1] for p in prns}, fs,
                          0.04, noise=True)
    kw = dict(KW, fs_hz=fs, code_length_chips=4092, code_samples_per_chip=2,
              veml=True, early_late_space_chips=0.15,
              very_early_late_space_chips=0.6)
    et = TrackingEngine(TrackConfig(**kw), codes, device="cpu")
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / 2.046e6 * fs,
                                 s.doppler_hz, 0, 0)
    return et, st, et._pad_for_chunks(torch.from_numpy(x))


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != first


def test_wrappers_count_only_kernel_launches(port_tracked):
    et, st, seg = port_tracked
    fst, ist, slot = _port_rows(et, st)
    sec_rows = et._sec[slot.long()].T.contiguous()
    before = (cc.launches, tc.launches)
    cc.chunk_corr(et.corr_spec, seg, et._rows, slot, fst, ist)
    tcap.track_capture(et.chain_spec, et.corr_spec, 2, seg, et._rows, slot,
                       sec_rows, fst, ist)
    assert (cc.launches, tc.launches) == before
    with pytest.raises(ValueError):
        cc.chunk_corr(et.corr_spec, seg, et._rows, slot, fst,
                      ist.to("meta"))
    with pytest.raises(ValueError):
        tcap.track_capture(et.chain_spec, et.corr_spec, 0, seg, et._rows,
                           slot, sec_rows, fst, ist)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")


@pytest.mark.gpu
def test_chunk_corr_kernel_matches_plain_on_gpu(port_tracked):
    _need_gpu()
    et, st, seg = port_tracked
    fst, ist, slot = _port_rows(et, st)
    args = [t.cuda() for t in (seg, et._rows, slot, fst, ist)]
    before = cc.launches
    got = cc.chunk_corr(et.corr_spec, *args)
    torch.cuda.synchronize()
    assert cc.launches == before + 1
    want = cc.chunk_corr_plain(et.corr_spec, *args)
    _, _, s_cpu, step0_cpu = cc.chunk_corr_plain(et.corr_spec, seg, et._rows,
                                                 slot, fst, ist)
    zr, zi, s_reg, step0 = (t.cpu() for t in got)
    wr, wi, ws, _ = (t.cpu() for t in want)
    torch.testing.assert_close(s_reg, ws, rtol=0, atol=0)
    torch.testing.assert_close(s_reg, s_cpu, rtol=0, atol=0)
    torch.testing.assert_close(step0, step0_cpu, rtol=0, atol=0)
    scale = float(max(wr.abs().max(), wi.abs().max()))
    torch.testing.assert_close(zr, wr, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(zi, wi, rtol=0, atol=1e-4 * scale)


@pytest.mark.gpu
def test_chunk_corr_kernel_matches_plain_in_blocks_on_gpu(capture):
    """24 epochs a chunk at 8.184 Msps: 48 plane-epoch rows and 86 lags,
    so the kernel walks two row blocks by two lag blocks, each summed over
    the cluster in turn."""
    _need_gpu()
    sats, codes, _ = capture
    fs = 8.184e6
    x = generate_baseband(GPS_L1_CA, sats, {p: codes[p - 1]
                                            for p in range(1, C + 1)},
                          fs, 0.04, noise=True)
    et = TrackingEngine(TrackConfig(**dict(KW, fs_hz=fs, chunk_epochs=24)),
                        codes, device="cpu")
    spec = et.corr_spec
    geo = cc.corr_geometry(spec.E, spec.LW, spec.NW, cc.MAX_CLUSTER)
    assert (geo.MB, geo.NB) == (2, 2)
    st = et.init_state()
    for ch, s in enumerate(sats):
        st = et.activate_channel(st, ch, ch, s.delay_chips / 1.023e6 * fs,
                                 s.doppler_hz, 0, 0)
    fst, ist, slot = _port_rows(et, st)
    seg = et._pad_for_chunks(torch.from_numpy(x))
    args = [t.cuda() for t in (seg, et._rows, slot, fst, ist)]
    got = cc.chunk_corr(spec, *args)
    want = cc.chunk_corr_plain(spec, seg, et._rows, slot, fst, ist)
    zr, zi, s_reg, step0 = (t.cpu() for t in got)
    torch.testing.assert_close(s_reg, want[2], rtol=0, atol=0)
    torch.testing.assert_close(step0, want[3], rtol=0, atol=0)
    scale = float(max(want[0].abs().max(), want[1].abs().max()))
    assert scale > 100.0
    torch.testing.assert_close(zr, want[0], rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(zi, want[1], rtol=0, atol=1e-4 * scale)


@pytest.mark.gpu
def test_track_capture_kernels_match_cpu_chunk_loop(port_tracked):
    _need_gpu()
    et, st, seg = port_tracked
    fst, ist, slot = _port_rows(et, st)
    sec_rows = et._sec[slot.long()].T.contiguous()
    n_chunks = 3
    cpu = (seg, et._rows, slot, sec_rows, fst, ist)
    want = tcap.track_capture(et.chain_spec, et.corr_spec, n_chunks, *cpu)
    before = (cc.launches, tc.launches)
    got = tcap.track_capture(et.chain_spec, et.corr_spec, n_chunks,
                             *(t.cuda() for t in cpu))
    torch.cuda.synchronize()
    assert (cc.launches, tc.launches) == (before[0] + n_chunks,
                                          before[1] + n_chunks)
    assert got[0].shape[0] == n_chunks * E
    names = ("out_f", "out_i", "out_corr", "fst", "ist")
    for name, g, w in zip(names, got, want):
        g, w = g.cpu(), w
        if g.dtype == torch.int32:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
            continue
        for r in range(g.shape[-2]):
            gr, wr = g[..., r, :], w[..., r, :]
            if name == "out_f" and r in (tc.O_VALID, tc.O_ACTIVE):
                torch.testing.assert_close(gr, wr, rtol=0, atol=0)
                continue
            scale = max(1.0, float(wr.abs().max()))
            torch.testing.assert_close(gr, wr, rtol=0, atol=1e-4 * scale,
                                       msg=f"{name} row {r}")


def test_kernel_constants_match_the_source():
    import pathlib
    import re

    src = (pathlib.Path(cc.__file__).parent.parent / "csrc"
           / "chunk_corr.cuh").read_text()

    def define(name):
        return int(re.search(rf"^#define {name} (\d+)", src, re.M).group(1))

    assert define("CC_THREADS") == cc.THREADS
    assert define("CC_MAX_CLUSTER") == cc.MAX_CLUSTER
    assert define("CC_ROWS") == cc.BLOCK_ROWS
    assert define("CC_LAGS") == cc.BLOCK_LAGS
    assert define("CC_KSTEP") == cc.KSTEP
    assert define("CC_KG") == cc.KGROUPS
    assert define("CC_RED_STRIDE") == cc.RED_STRIDE
    # one cluster launch a chunk, the cluster from the card's occupancy
    assert "cudaLaunchKernelEx" in src and "<<<" not in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src
