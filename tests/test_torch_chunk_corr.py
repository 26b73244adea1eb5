"""The port's chunk correlator (ops/chunk_corr.py) and capture-level entry
(ops/track_capture.py).

- `chunk_corr_plain` against the JAX package's `_chunk_windows` plus the
  `einsum` lag correlation (engine with correlator='mxu', on the CPU), on
  the same capture and state: lag windows at atol 1e-4 of max|z| (the two
  sum the products in another order), slice origins and step0 exact.
- The Toeplitz replica-row table against the full bank `rep_rows_np`, bit
  for bit.
- The kernel's block geometry keeps every shared-memory index in range.
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

from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_1_tpu_torch.constants import GPS_L1_CA
from gnss_sdr_1_tpu_torch.ops import _build
from gnss_sdr_1_tpu_torch.ops import chunk_corr as cc
from gnss_sdr_1_tpu_torch.ops import track_capture as tcap
from gnss_sdr_1_tpu_torch.ops import track_chain as tc
from gnss_sdr_1_tpu_torch.siggen import SatParams, generate_baseband
from gnss_sdr_1_tpu_torch.track import TrackConfig, TrackingEngine
from gnss_sdr_1_tpu_torch.track.engine import state_from_numpy

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


def _engine_spec(fs, E_, C_):
    codes = np.stack([gps_l1ca_code(p) for p in range(1, 3)])
    cfg = TrackConfig(**dict(KW, fs_hz=fs, chunk_epochs=E_, n_channels=C_))
    return TrackingEngine(cfg, codes, device="cpu").corr_spec


@pytest.mark.parametrize("fs,E_,C_", [(4.092e6, 16, 12), (FS, E, C),
                                      (2.046e6, 16, 12), (8.184e6, 20, 8)])
def test_corr_geometry_stays_in_shared_memory(fs, E_, C_):
    """Every index the kernel's threads read: wiped samples in [0, S*L),
    replica row entries in [0, qs) with the staged row inside it, the
    partial sums inside the samples buffer."""
    spec = _engine_spec(fs, E_, C_)
    p = cc.corr_params(spec)
    NG = -(-spec.LW // p.tl)
    assert p.threads == NG * p.S <= cc.THREADS
    assert p.L % p.tl == 0 and p.S * p.L >= spec.NW
    assert 2 * p.S * NG * p.tl <= p.wbuf and 2 * p.S * p.L <= p.wbuf
    assert p.wbuf % 4 == 0 and p.qs % 4 == 0      # 16-byte row copies
    assert p.padl + spec.QW <= p.qs
    # q index of (n, l) is n - l + LW - 1 + padl, over n < S*L and every
    # lag the groups compute, l < NG * TL
    lo = 0 - (NG * p.tl - 1) + spec.LW - 1 + p.padl
    hi = p.S * p.L - 1 + spec.LW - 1 + p.padl
    assert lo >= 0 and hi < p.qs
    assert p.smem_bytes == 4 * (p.wbuf + p.qs) <= cc.MAX_SMEM
    assert spec.seg_len == (spec.E - 1) * spec.t0_int + spec.NW


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
