"""The launch geometry the KF and gather cluster walks share
(ops/cluster_walk.py), on the CPU: the fit to the largest cluster the card
schedules, with the card's answer (the libraries' `*_max_cluster` entries)
replaced by a stand-in, and the prefetch buffer's size against the kernels'
header (csrc/cluster_walk.cuh)."""

import pathlib
import re

import pytest

from gnss_sdr_1_tpu_torch.ops import cluster_walk as cw
from gnss_sdr_1_tpu_torch.ops import gather_block as gb
from gnss_sdr_1_tpu_torch.ops import kf_block as kb

CUH = pathlib.Path(cw.__file__).resolve().parent.parent / "csrc" \
    / "cluster_walk.cuh"
# (geometry(C, max_cluster), the kernel's largest cluster) of both walks
# at the GPS L1 C/A shape (4.092 Msps)
WALKS = {
    "kf": (lambda C, n: kb.kf_geometry(C, 4094, 1023, 20, n),
           kb.KF_MAX_CLUSTER),
    "gather": (lambda C, n: gb.gather_geometry(C, 3, 4094, 1023, 1, n),
               gb.GB_MAX_CLUSTER),
}


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("C, card, n_cta, cpc",
                         [(12, 16, 12, 1), (12, 8, 8, 2), (20, 16, 16, 2),
                          (20, 6, 6, 4), (1, 16, 1, 1)])
def test_fit_to_card_takes_the_cards_largest_cluster(walk, C, card, n_cta,
                                                     cpc):
    geometry, limit = WALKS[walk]
    asked = []

    def card_max(smem):
        asked.append(smem)
        return card

    geo = cw.fit_to_card(lambda n: geometry(C, n), card_max, limit)
    assert (geo.n_cta, geo.cpc) == (n_cta, cpc)
    assert geo == geometry(C, min(limit, card))
    # asked at the shared memory of each geometry tried, the last the one
    # returned
    assert asked[-1] == geo.smem and len(asked) <= 2


def test_fit_to_card_raises_when_the_card_schedules_none():
    geometry, limit = WALKS["gather"]
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        cw.fit_to_card(lambda n: geometry(12, n), lambda smem: -7, limit)


def test_prefetch_buffer_matches_the_header():
    src = CUH.read_text()
    assert "return round16(8 * (n_max + 2));" in src
    for n_max in (1, 4094, 16003, 40968):
        b = cw.prefetch_bytes(n_max)
        assert b % 16 == 0 and 8 * (n_max + 1) <= b < 8 * (n_max + 2) + 16
    for name, value in (("CLUSTER_PORTABLE", cw.PORTABLE_CLUSTER),
                        ("CLUSTER_SMEM_MAX", cw.SMEM_MAX)):
        m = re.search(rf"^#define {name} (\d+)$", src, re.M)
        assert m and int(m.group(1)) == value, name
