"""Port parity: LD clumping. The clump sets come from exact integer pair
sums, so the port's must EQUAL the JAX package's (its host finalize), for
given ranks and the default MAF ranks, windows in kb and in SNPs, row
subsets, several chromosomes and excluded variants."""

import numpy as np
import pytest
import torch

from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.ops import clumping as jclump
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import clumping as pclump

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def ld_packs(seed, n=120, m=160, na_prob=0.02):
    """Correlated genotypes (neighbouring columns copied with noise), as a
    JAX pack and a port pack on the same bytes."""
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, rng.uniform(0.05, 0.5, m)[None, :],
                     size=(n, m)).astype(float)
    for j in range(1, m):
        if rng.random() < 0.6:
            src = j - rng.integers(1, min(j, 8) + 1)
            mask = rng.random(n) < 0.85
            X[mask, j] = X[mask, src]
    X[rng.random((n, m)) < na_prob] = np.nan
    packed = junpack.np_pack_codes(junpack.np_dosage_to_codes(X.T))
    return JaxGenoPack(packed=packed, n=n), interop.pack_from_numpy(packed, n)


@pytest.mark.parametrize("seed,thr", [(1, 0.2), (2, 0.05), (3, 0.5),
                                      (4, 0.8)])
@pytest.mark.parametrize("na_prob", [0.0, 0.02])
def test_clump_sets_equal_jax_kb_windows(seed, thr, na_prob):
    jp, pp = ld_packs(seed, na_prob=na_prob)
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, 90_000, jp.m)).astype(float)
    S = rng.random(jp.m)
    for kw in (dict(S=S), dict()):                  # given S, default MAF
        j = jclump.snp_clumping(jp, infos_chr=np.ones(jp.m, int),
                                thr_r2=thr, size=12, infos_pos=pos,
                                block=32, **kw)
        p = pt.snp_clumping(pp, infos_chr=np.ones(jp.m, int), thr_r2=thr,
                            size=12, infos_pos=pos, block=32, **kw)
        np.testing.assert_array_equal(p, j)
        assert 0 < len(p) < jp.m


@pytest.mark.parametrize("size", [3, 10, 40])
def test_clump_sets_equal_jax_snp_windows(size):
    jp, pp = ld_packs(7, n=90, m=130)
    ind_row = np.arange(0, 90, 3)[:25]
    for kw in (dict(), dict(ind_row=ind_row)):
        j = jclump.snp_clumping(jp, infos_chr=np.ones(130, int), thr_r2=0.1,
                                size=size, block=16, **kw)
        p = pt.snp_clumping(pp, infos_chr=np.ones(130, int), thr_r2=0.1,
                            size=size, block=16, **kw)
        np.testing.assert_array_equal(p, j)


def test_multichrom_exclude_and_bed_clumping_equal_jax():
    jp, pp = ld_packs(11, n=150, m=200, na_prob=0.03)
    chrs = np.repeat([1, 2, 5], [70, 80, 50])
    pos = np.concatenate([np.arange(1, 71), np.arange(1, 81),
                          np.arange(1, 51)]) * 2_000.0
    exclude = [0, 1, 69, 70, 150, 199]
    rows = np.sort(np.random.default_rng(0).choice(150, 120, replace=False))
    kw = dict(infos_chr=chrs, thr_r2=0.2, size=30, infos_pos=pos,
              exclude=exclude, ind_row=rows)
    j = jclump.snp_clumping(jp, **kw)
    p = pt.snp_clumping(pp, **kw)
    np.testing.assert_array_equal(p, j)
    assert not np.isin(exclude, p).any()
    import pandas as pd

    jp.map = pd.DataFrame({"chromosome": chrs})     # the JAX package's map
    pp.map = {"chromosome": chrs}                   # the port's
    j = jclump.bed_clumping(jp, ind_row=rows, thr_r2=0.2, size=30,
                            infos_pos=pos)
    p = pt.bed_clumping(pp, ind_row=rows, thr_r2=0.2, size=30, infos_pos=pos)
    np.testing.assert_array_equal(p, j)


def test_indLRLDR_equal_jax():
    rng = np.random.default_rng(5)
    chrs = rng.integers(1, 24, 5000)
    pos = rng.integers(0, 150_000_000, 5000)
    np.testing.assert_array_equal(pt.snp_indLRLDR(chrs, pos),
                                  jclump.snp_indLRLDR(chrs, pos))
    regions = np.array([(1, 0, 10_000_000), (7, 5, 90_000_000)])
    np.testing.assert_array_equal(pt.snp_indLRLDR(chrs, pos, regions),
                                  jclump.snp_indLRLDR(chrs, pos, regions))
    np.testing.assert_array_equal(pclump.LD_WIKI34, jclump.LD_WIKI34)


def random_conflicts(rng, m, K):
    """Conflict edges to up to K right neighbours each, about 70% kept,
    in random order and orientation, with some duplicates."""
    ei, ej = [], []
    for k in range(1, min(K, m - 1) + 1):
        a = np.nonzero(rng.random(m - k) < 0.7)[0]
        ei.append(a)
        ej.append(a + k)
    ei, ej = np.concatenate(ei), np.concatenate(ej)
    flip = rng.random(len(ei)) < 0.5
    ei, ej = np.where(flip, ej, ei), np.where(flip, ei, ej)
    dup = rng.choice(len(ei), len(ei) // 20)
    ei, ej = np.r_[ei, ei[dup]], np.r_[ej, ej[dup]]
    order = rng.permutation(len(ei))
    return ei[order], ej[order]


@pytest.mark.parametrize("m,K", [(1, 0), (50, 3), (900, 40), (700, 500)])
def test_native_greedy_equals_jax_fixed_point(m, K):
    """The native O(m + E) greedy, bit-equal to the JAX package's fixed
    point and to its numpy copy, on random conflict graphs."""
    rng = np.random.default_rng(m + K)
    ei, ej = (random_conflicts(rng, m, K) if K else
              (np.array([], np.int64), np.array([], np.int64)))
    rank = rng.permutation(m)
    got = pclump._greedy_fixed_point(m, rank, ei, ej)
    np.testing.assert_array_equal(got, jclump._greedy_fixed_point(
        m, rank, ei, ej))
    np.testing.assert_array_equal(got, pclump._greedy_fixed_point_plain(
        m, rank, ei, ej))
    assert got.dtype == bool and got[np.argmin(rank)]


def test_native_greedy_refuses_bad_graphs():
    with pytest.raises(RuntimeError, match="self-edge"):
        pclump._greedy_fixed_point(3, np.arange(3), [1], [1])
    with pytest.raises(ValueError, match="out of range"):
        pclump._greedy_fixed_point(3, np.arange(3), [0], [3])
    with pytest.raises(ValueError, match="out of range"):
        pclump._greedy_fixed_point(3, np.array([0, 0, 1]), [0], [1])


def test_native_library_builds_once_under_many_threads(tmp_path, monkeypatch):
    """Threads that first load one native source together build it once
    and share one library (the stacking CD loads from 10 fold threads)."""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from bigsnpr_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_libs", {})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(16, timeout=60)

        def load(_):
            start.wait()
            return cuda_build.load(pclump.CLUMP_SOURCE, pclump._bind_clump)

        with ThreadPoolExecutor(16) as pool:
            libs = list(pool.map(load, range(16), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert all(lib is libs[0] for lib in libs)
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert not list(tmp_path.glob(".*.tmp"))
