"""The KF block kernel's launch geometry (ops/kf_block.py kf_geometry), on
the CPU: one cluster of min(C, max_cluster) thread blocks, channels dealt
to them in rounds, the dynamic shared memory each needs and whether the
sample prefetch buffers fit, at the KF shape of every signal the receiver
builds and at channel counts around the cluster sizes.  The kernel itself
(csrc/kf_block.cu) runs only on the card; its constants are read from the
source here so that the two cannot drift apart."""

import functools
import pathlib
import re

import pytest

from gnss_sdr_1_tpu_torch.ops import kf_block as kb

CU = pathlib.Path(kb.__file__).resolve().parent.parent / "csrc" / "kf_block.cu"
SIGNALS = ("1C", "1B", "L5", "5X", "2S", "1G", "2G", "B1", "B3")
CLUSTERS = (8, 16)
# the GPS L1 C/A engine at 4.092 Msps: epoch_samples_max, L, cn0_samples
GPS_SHAPE = (4094, 1023, 20)


@functools.lru_cache(maxsize=None)
def _receiver_shape(sid):
    """(C, n_max, code_len, n_hist) of the KF engine the receiver builds
    for `sid` with its default configuration."""
    from gnss_sdr_1_tpu_torch.runtime import Receiver, ReceiverConfig

    rx = Receiver(ReceiverConfig(signal_id=sid, track_engine="kf",
                                 prn_search=(1,) if sid != "B1" else (6,)),
                  device="cpu")
    spec = rx.trk.block_spec(int(round(rx.cfg.fs_hz * 0.04)))
    return spec.C, spec.n_max, spec.code_len, spec.n_hist


def _cu_define(name):
    m = re.search(rf"^#define {name} (\d+)$", CU.read_text(), re.M)
    assert m, f"{name} not defined in {CU.name}"
    return int(m.group(1))


def _check(C, n_max, code_len, n_hist, max_cluster):
    geo = kb.kf_geometry(C, n_max, code_len, n_hist, max_cluster)
    # every channel in exactly one CTA (CTA r takes r, r + n_cta, ...), no
    # CTA idle, at most cpc each
    owned = [range(r, C, geo.n_cta) for r in range(geo.n_cta)]
    assert sorted(c for chans in owned for c in chans) == list(range(C))
    assert min(map(len, owned)) >= 1 and max(map(len, owned)) == geo.cpc
    # the cluster: the kernel's largest, non-portable (the C entry allows
    # it) only past 8
    assert geo.n_cta == min(C, max_cluster) <= max_cluster
    assert geo.n_cta <= kb.PORTABLE_CLUSTER or max_cluster > 8
    # shared memory, and the prefetch exactly where its buffers fit
    with_pf = kb.kf_layout(geo.cpc, n_max, code_len, n_hist, True)["total"]
    without = kb.kf_layout(geo.cpc, n_max, code_len, n_hist, False)["total"]
    assert geo.prefetch == (with_pf <= kb.SMEM_MAX)
    assert geo.smem == (with_pf if geo.prefetch else without)
    assert geo.smem <= kb.SMEM_MAX
    if geo.prefetch:
        assert geo.pf_bytes % 16 == 0 and geo.pf_bytes >= 8 * (n_max + 1)
        lay = kb.kf_layout(geo.cpc, n_max, code_len, n_hist, True)
        assert lay["pf"] % 16 == 0 and lay["bits"] - lay["pf"] \
            == geo.cpc * geo.pf_bytes
    else:
        assert geo.pf_bytes == 0
    # threads: whole warps, the kernel's launch bound
    assert geo.threads % 32 == 0 and geo.threads == kb.KF_THREADS
    return geo


@pytest.mark.parametrize("max_cluster", CLUSTERS)
@pytest.mark.parametrize("sid", SIGNALS)
def test_geometry_of_every_receiver_kf_shape(sid, max_cluster):
    C, n_max, code_len, n_hist = _receiver_shape(sid)
    geo = _check(C, n_max, code_len, n_hist, max_cluster)
    assert geo.cpc == 1                 # the receivers' 8 channels
    # a 20 ms L2CM epoch (~80,000 samples at 4 Msps) leaves no room for
    # its buffer; every 1 ms or 4 ms epoch prefetches
    assert geo.prefetch == (sid != "2S")


@pytest.mark.parametrize("max_cluster", CLUSTERS)
@pytest.mark.parametrize("C", (1, 8, 12, 16, 17, 20))
def test_geometry_of_channel_counts(C, max_cluster):
    geo = _check(C, *GPS_SHAPE, max_cluster)
    assert geo.cpc == -(-C // min(C, max_cluster))     # rounds past it
    assert geo.prefetch                 # GPS: a 33 KB buffer per channel


def test_geometry_matches_the_kernel_source():
    src = CU.read_text()
    assert _cu_define("KF_THREADS") == kb.KF_THREADS
    assert "__launch_bounds__(KF_THREADS, 1)" in src
    assert _cu_define("KF_MAX_CLUSTER") == kb.KF_MAX_CLUSTER
    assert _cu_define("KF_PORTABLE_CLUSTER") == kb.PORTABLE_CLUSTER
    assert _cu_define("KF_SMEM_MAX") == kb.SMEM_MAX
    assert _cu_define("KF_STAGE_POINTS") == kb.STAGE_POINTS
    for name in ("TL_START", "TL_M0", "TL_PRE", "TL_RED", "TL_UPD", "TL_M32",
                 "TL_WAIT", "TL_SAMP", "TL_PART", "TL_HIT"):
        m = re.search(rf"^#define {name} (\d+) ", src, re.M)
        assert m and int(m.group(1)) == getattr(kb, name), name
    assert _cu_define("KF_PRE_BYTES") == kb.PRE_BYTES
    assert "static_assert(sizeof(KfPre) == KF_PRE_BYTES" in src
    # no single-block launch left: one cluster through cudaLaunchKernelEx
    assert "<<<" not in src and "cudaLaunchKernelEx" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    # clusters past the portable size are allowed explicitly
    assert "n_cta > KF_PORTABLE_CLUSTER" in src
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src


def test_geometry_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        kb.kf_geometry(12, *GPS_SHAPE, 0)
    with pytest.raises(ValueError):
        kb.kf_geometry(12, *GPS_SHAPE, kb.KF_MAX_CLUSTER + 1)
    with pytest.raises(ValueError):
        kb.kf_geometry(0, *GPS_SHAPE, 16)
    with pytest.raises(ValueError):     # history rows beyond shared memory
        kb.kf_geometry(20, 4094, 1023, 40_000, 8)


def test_kf_params_carry_the_geometry():
    """The ctypes mirror of the kernel's KfParams holds the geometry the
    kernel checks at launch."""
    import numpy as np

    from gnss_sdr_1_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_1_tpu_torch.track.kf import KfTrackConfig, KfTrackingEngine

    eng = KfTrackingEngine(
        KfTrackConfig(fs_hz=4.092e6, code_length_chips=1023,
                      chip_rate_chips_s=1.023e6, carrier_freq_hz=1575.42e6,
                      n_channels=20),
        np.stack([gps_l1ca_code(p) for p in range(1, 21)]), device="cpu")
    spec = eng.block_spec(163_680, 25)
    geo = kb.kf_geometry(spec.C, spec.n_max, spec.code_len, spec.n_hist, 16)
    p = kb.kf_params(spec, 25 * 163_680 + spec.n_max, geo)
    assert (p.C, p.n_cta, p.cpc, p.threads) == (20, 16, 2, kb.KF_THREADS)
    assert (p.prefetch, p.pf_bytes, p.smem) == (1, geo.pf_bytes, geo.smem)
    assert p.n_max == spec.n_max == GPS_SHAPE[0]
    with pytest.raises(ValueError):
        kb.kf_params(spec, 1, kb.kf_geometry(12, *GPS_SHAPE, 16))
