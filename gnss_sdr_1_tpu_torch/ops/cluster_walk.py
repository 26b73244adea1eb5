"""The launch geometry the cluster walks share (ops/kf_block.py,
ops/gather_block.py; the CUDA side is csrc/cluster_walk.cuh).

A walk launches one thread-block cluster of n_cta = min(C, max_cluster)
CTAs, one channel per CTA and rounds past the cluster (CTA r takes channels
r, r + n_cta, ...: cpc at most).  Each CTA holds its channels' state in
dynamic shared memory, and a prefetch buffer per channel where all of it
fits in SMEM_MAX bytes.  `max_cluster` is the largest cluster the card
schedules at that shared memory (cudaOccupancyMaxActiveClusters, asked at
first launch through each library's `*_max_cluster` entry).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

# the portable cluster size (above it the launch sets
# cudaFuncAttributeNonPortableClusterSizeAllowed) and the dynamic shared
# memory one CTA may use on Hopper (cluster_walk.cuh CLUSTER_PORTABLE,
# CLUSTER_SMEM_MAX)
PORTABLE_CLUSTER = 8
SMEM_MAX = 232_448


def round16(v: int) -> int:
    return (v + 15) // 16 * 16


def prefetch_bytes(n_max: int) -> int:
    """One prefetch buffer: n_max samples from a 16-byte aligned start
    (one sample of skew at most) rounded up to 16 bytes."""
    return round16(8 * (n_max + 2))


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """One launch: a cluster of n_cta CTAs of `threads` threads; CTA r
    takes channels r, r + n_cta, ... (at most `cpc` each); `prefetch`
    where every CTA's cpc buffers of `pf_bytes` fit beside the rest in
    `smem` bytes of dynamic shared memory."""

    C: int
    n_cta: int
    threads: int
    cpc: int
    prefetch: bool
    pf_bytes: int
    smem: int


def cluster_geometry(C: int, n_max: int, threads: int, max_cluster: int,
                     limit: int, smem_total: Callable[[int, bool], int],
                     what: str) -> ClusterGeometry:
    """The geometry of C channels under clusters of up to `max_cluster`
    CTAs (at most `limit`, the kernel's own); `smem_total(cpc, prefetch)`
    is the kernel's layout, `what` names the shape in the error raised
    when even the layout without prefetch buffers does not fit."""
    if not 1 <= max_cluster <= limit:
        raise ValueError(f"max_cluster must be in [1, {limit}], got "
                         f"{max_cluster}")
    if C < 1:
        raise ValueError("a cluster walk takes at least one channel")
    n_cta = min(C, max_cluster)
    cpc = -(-C // n_cta)
    smem = smem_total(cpc, True)
    prefetch = smem <= SMEM_MAX
    if not prefetch:
        smem = smem_total(cpc, False)
        if smem > SMEM_MAX:
            raise ValueError(f"{C} channels of {what} need {smem} B of "
                             f"shared memory a CTA (at most {SMEM_MAX})")
    return ClusterGeometry(C=C, n_cta=n_cta, threads=threads, cpc=cpc,
                           prefetch=prefetch,
                           pf_bytes=prefetch_bytes(n_max) if prefetch else 0,
                           smem=smem)


def fit_to_card(geometry: Callable[[int], ClusterGeometry],
                card_max: Callable[[int], int],
                limit: int) -> ClusterGeometry:
    """The geometry at the largest cluster the card schedules:
    `geometry(max_cluster)` from `limit` down, until `card_max(smem)` (the
    library's `*_max_cluster` entry: the largest cluster at that shared
    memory, or minus a CUDA error) takes its n_cta."""
    geo = geometry(limit)
    while True:
        n = card_max(geo.smem)
        if n < 1:
            raise RuntimeError(f"the card schedules no cluster of "
                               f"{geo.smem} B of shared memory a CTA: CUDA "
                               f"error {-n}")
        if n >= geo.n_cta:
            return geo
        geo = geometry(n)
