"""Greedy LD clumping (port of `bigsnpr_tpu/ops/clumping.py`).

Reference: snp_clumping (R/clumping.R:62-137) with the lock-free tri-state
spin-wait protocol of src/clumping.cpp:33-91: process variants in rank
order of a statistic S (default MAF); keep j0 iff no already-kept
higher-ranked neighbour within the window has r^2 > thr. The output is
order-deterministic.

As in the JAX package, the per-pair dots are the banded blocks of exact
integer pair sums (`ops/corr.py`), and the greedy runs on the conflict
graph (edges = window pairs with r^2 > thr). Where the JAX package finds
its keep set by a fixed point (one pass over every edge per round), the
port walks the variants once in rank order in `native/clump_native.cpp`
(built with g++ at first use), in O(m + E): the same keep set, kept
here as `_greedy_fixed_point_plain` for the tests. r is the float64
pairwise-complete Pearson r of the JAX package's host path, computed with
torch on the sums' device; only the conflict edges leave the device.
Clump sets equal the JAX package's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.ops import cuda_build
from bigsnpr_tpu_torch.ops.corr import (
    _iter_band_blocks,
    _pack_is_nona,
    _window_geometry,
    _window_r2,
)
from bigsnpr_tpu_torch.ops.stats import snp_colstats, snp_counts
from bigsnpr_tpu_torch.utils.assertions import check_args


def _conflict_edges(sub, pos, size_scaled, thr_r2, block=512, device=None):
    """(i, j) pairs (i < j) within the window with r^2 > thr_r2."""
    if hasattr(sub, "code256"):
        raise NotImplementedError("clumping a DosagePack: ROADMAP slice 6")
    dev = config.resolve_device(device)
    n, m = sub.n, sub.m
    left_start = _window_geometry(pos, size_scaled)
    dev_packed = sub.device_packed(dev)
    nona = _pack_is_nona(sub, dev_packed, n)
    ls_dev = torch.as_tensor(left_start, device=dev)
    ei, ej = [], []
    for t0, t1, b0, sums in _iter_band_blocks(dev_packed, n, m, left_start,
                                              block, nona):
        i, j, _ = _window_r2(sums, t0, t1, b0, ls_dev, thr_r2)
        if len(i):
            ei.append(i)
            ej.append(j)
    if not ei:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64)
    return np.concatenate(ei), np.concatenate(ej)


CLUMP_SOURCE = cuda_build.PKG / "native" / "clump_native.cpp"


def _bind_clump(lib):
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.clump_greedy.argtypes = [i64, p, i64, p, p, p]
    lib.clump_greedy.restype = ctypes.c_int


def _greedy_fixed_point(m, rank, ei, ej):
    """Decide keep/prune for all variants: the sequential greedy in rank
    order (rank[j] smaller = higher priority; rank a permutation of
    0..m-1), keeping a variant iff none of its higher-priority conflict
    neighbours was kept. One pass in `native/clump_native.cpp`; the keep
    set is `_greedy_fixed_point_plain`'s. Returns a bool (m,) mask."""
    lib = cuda_build.load(CLUMP_SOURCE, _bind_clump)
    rank = np.ascontiguousarray(rank, dtype=np.int64)
    ei = np.ascontiguousarray(ei, dtype=np.int64)
    ej = np.ascontiguousarray(ej, dtype=np.int64)
    if len(rank) != m or len(ei) != len(ej):
        raise ValueError("rank must have m entries and ei, ej one length")
    keep = np.zeros(m, dtype=np.uint8)
    rc = lib.clump_greedy(m, rank.ctypes.data, len(ei), ei.ctypes.data,
                          ej.ctypes.data, keep.ctypes.data)
    if rc == 1:
        raise RuntimeError("clumping fixed point stalled: a self-edge")
    if rc != 0:
        raise ValueError("clumping: an edge index or a rank is out of range")
    return keep.astype(bool)


def _greedy_fixed_point_plain(m, rank, ei, ej):
    """The JAX package's fixed point in numpy (the tests' reference for
    `_greedy_fixed_point`): decide keep/prune for all variants; equals
    sequential greedy in rank order (rank[j] smaller = higher priority)."""
    # orient each conflict edge: hi = higher-priority endpoint
    swap = rank[ei] > rank[ej]
    hi = np.where(swap, ej, ei)
    lo = np.where(swap, ei, ej)

    keep = np.full(m, -1, dtype=np.int8)  # -1 unknown, 0 pruned, 1 kept
    # variants with no higher-ranked conflicts are kept immediately
    for _ in range(m + 1):
        undecided = keep == -1
        if not undecided.any():
            break
        # OR-scatters (the JAX package's np.logical_or.at) as assignments
        # of True, the same result at a fraction of the cost
        blocked = np.zeros(m, dtype=bool)       # has undecided higher neighbor
        blocked[lo[undecided[hi]]] = True
        pruned = np.zeros(m, dtype=bool)        # has kept higher neighbor
        pruned[lo[keep[hi] == 1]] = True
        ready = undecided & ~blocked
        if not ready.any():  # cannot happen (DAG), safety
            raise RuntimeError("clumping fixed point stalled")
        keep[ready & pruned] = 0
        keep[ready & ~pruned] = 1
    return keep == 1


@check_args()
def snp_clumping(
    pack,
    infos_chr=None,
    ind_row=None,
    S=None,
    thr_r2: float = 0.2,
    size: float | None = None,
    infos_pos=None,
    exclude=None,
    block: int = 512,
    device=None,
) -> np.ndarray:
    """Indices of variants KEPT by LD clumping (reference snp_clumping).

    size: window in #SNPs if infos_pos is None, else kb. Default 100/thr_r2.
    Each chromosome's rows `ind_row` are repacked on the device."""
    dev = config.resolve_device(device)
    m_all = pack.m
    if infos_chr is None:
        infos_chr = (pack.map["chromosome"]
                     if pack.map is not None else np.ones(m_all, dtype=int))
    infos_chr = np.asarray(infos_chr)
    assert len(infos_chr) == m_all
    if size is None:
        size = 100 / thr_r2
    if S is not None:
        S = np.asarray(S, dtype=np.float64)
        assert len(S) == m_all

    ind_noexcl = np.arange(m_all)
    if exclude is not None:
        ind_noexcl = np.setdiff1d(ind_noexcl, np.asarray(exclude))

    kept_all = []
    for chrom in np.unique(infos_chr[ind_noexcl]):
        ind_chr = ind_noexcl[infos_chr[ind_noexcl] == chrom]
        sub = pack.subset(ind_row=ind_row, ind_col=ind_chr, device=dev)
        mc = sub.m

        # rank statistic (default MAF, reference R/clumping.R:100-106)
        if S is None:
            st = snp_colstats(sub, device=dev)
            af = st["sumX"] / (2 * np.maximum(st["nona"], 1))
            S_chr = np.minimum(af, 1 - af)
        else:
            S_chr = S[ind_chr]
        ord_ = np.argsort(-S_chr, kind="stable")
        rank = np.empty(mc, dtype=np.int64)
        rank[ord_] = np.arange(mc)

        if infos_pos is None:
            pos = np.arange(1, mc + 1, dtype=np.float64)
            size_scaled = float(size)
        else:
            pos = np.asarray(infos_pos, dtype=np.float64)[ind_chr]
            assert np.all(np.diff(pos) >= 0), "positions must be sorted"
            size_scaled = float(size) * 1000.0

        ei, ej = _conflict_edges(sub, pos, size_scaled, thr_r2, block=block,
                                 device=dev)
        keep = _greedy_fixed_point(mc, rank, ei, ej)
        kept_all.append(ind_chr[keep])

    return (np.sort(np.concatenate(kept_all)) if kept_all
            else np.array([], dtype=int))


def bed_clumping(pack, ind_row=None, thr_r2=0.2, size=None, exclude=None,
                 block=512, device=None, **kw) -> np.ndarray:
    """bed_autoSVD's clumping (rank = MAC, reference R/bed-clumping.R:7-74).

    Equivalent to snp_clumping ranked by minor allele count; on a fixed
    ind_row, MAC order == MAF order up to per-variant missingness.
    """
    m_all = pack.m
    counts = snp_counts(pack, ind_row=ind_row, device=device)
    ac = counts[1] + 2 * counts[2]
    nb_nona = counts[:3].sum(0)
    mac = np.minimum(ac, 2 * nb_nona - ac).astype(np.float64)
    infos_chr = (pack.map["chromosome"]
                 if pack.map is not None else np.ones(m_all, dtype=int))
    infos_pos = kw.pop("infos_pos", None)
    return snp_clumping(pack, infos_chr=infos_chr, ind_row=ind_row, S=mac,
                        thr_r2=thr_r2, size=size, infos_pos=infos_pos,
                        exclude=exclude, block=block, device=device)


# Long-range LD regions (reference R/clumping.R:159-186 + data/LD.wiki34.rda)
# 34 regions of https://genome.sph.umich.edu/wiki/Regions_of_high_linkage_disequilibrium_(LD)
LD_WIKI34 = np.array([
    (1, 48060567, 52060567),     # hild1
    (2, 85941853, 100407914),    # hild2
    (2, 134382738, 137882738),   # hild3
    (2, 182882739, 189882739),   # hild4
    (3, 47500000, 50000000),     # hild5
    (3, 83500000, 87000000),     # hild6
    (3, 89000000, 97500000),     # hild7
    (5, 44500000, 50500000),     # hild8
    (5, 98000000, 100500000),    # hild9
    (5, 129000000, 132000000),   # hild10
    (5, 135500000, 138500000),   # hild11
    (6, 25500000, 33500000),     # hild12
    (6, 57000000, 64000000),     # hild13
    (6, 140000000, 142500000),   # hild14
    (7, 55193285, 66193285),     # hild15
    (8, 8000000, 12000000),      # hild16
    (8, 43000000, 50000000),     # hild17
    (8, 112000000, 115000000),   # hild18
    (10, 37000000, 43000000),    # hild19
    (11, 46000000, 57000000),    # hild20
    (11, 87500000, 90500000),    # hild21
    (12, 33000000, 40000000),    # hild22
    (12, 109521663, 112021663),  # hild23
    (20, 32000000, 34500000),    # hild24
    (23, 14150264, 16650264),    # hild25
    (23, 25650264, 28650264),    # hild26
    (23, 33150264, 35650264),    # hild27
    (23, 55133704, 60500000),    # hild28
    (23, 65133704, 67633704),    # hild29
    (23, 71633704, 77580511),    # hild30
    (23, 80080511, 86080511),    # hild31
    (23, 100580511, 103080511),  # hild32
    (23, 125602146, 128102146),  # hild33
    (23, 129102146, 131602146),  # hild34
], dtype=np.int64)


def snp_indLRLDR(infos_chr, infos_pos, LD_regions=None) -> np.ndarray:
    """Variant indices inside long-range LD regions
    (reference snp_indLRLDR, R/clumping.R:177-186)."""
    infos_chr = np.asarray(infos_chr)
    infos_pos = np.asarray(infos_pos)
    regions = LD_WIKI34 if LD_regions is None else np.asarray(LD_regions)
    hits = []
    for chrom, start, stop in regions:
        hits.append(np.nonzero(
            (infos_chr == chrom) & (infos_pos >= start) & (infos_pos <= stop))[0])
    return np.concatenate(hits) if hits else np.array([], dtype=int)
