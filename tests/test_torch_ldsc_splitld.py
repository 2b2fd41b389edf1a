"""Port parity: LDSC (`snp_ldsc`, `snp_ldsc2`), `snp_ldsplit` and
`auto_blocks` against the JAX package.

LDSC is host float64 in both packages: rtol 1e-10. `snp_ldsplit` runs the
same native DP (a copy of the C++ source, built by the port with g++):
costs, block ends and perc_kept equal, tie-breaks included, on the
reference's hand-computed toy (tests/testthat/test-4-split-LD.R) and on
random banded LD. `auto_blocks`: equal block sizes."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.ops.corr import SparseLD as JaxSparseLD, snp_cor as j_cor
from bigsnpr_tpu.ops.splitld import snp_ldsplit as j_ldsplit
from bigsnpr_tpu.pgs import ldsc as jldsc
from bigsnpr_tpu.pgs.gibbs_blocked import auto_blocks as j_auto_blocks
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops.splitld import COLUMNS, block_num
from bigsnpr_tpu_torch.pgs import ldsc as pldsc

from oracle_native import private_native


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX oracle's native library, built for this test process alone
    (tests/oracle_native.py), so that no oracle falls back to numpy."""
    yield from private_native(tmp_path_factory)

torch.set_num_threads(2)


def to_port(upper):
    upper = sp.csc_matrix(upper)
    return interop.sparse_ld_from_numpy(upper.data, upper.indices,
                                        upper.indptr, upper.shape)


def same_split(got, ref):
    if ref is None:
        return got is None
    if got is None or len(got["cost"]) != len(ref):
        return False
    assert set(got) == set(COLUMNS)
    for i, (_, row) in enumerate(ref.iterrows()):
        for name in ("max_size", "n_block", "cost", "cost2", "perc_kept"):
            if got[name][i] != row[name]:
                return False
        if not (np.array_equal(got["all_last"][i], row["all_last"])
                and np.array_equal(got["all_size"][i], row["all_size"])):
            return False
    return True


def banded(m, W, seed, p=0.4):
    rng = np.random.default_rng(seed)
    corr = np.eye(m)
    for j in range(m):
        for i in range(max(0, j - W), j):
            if rng.random() < p:
                corr[i, j] = corr[j, i] = rng.uniform(-0.8, 0.8)
    return corr


@pytest.mark.parametrize("intercept,blocks", [(1.0, None), (None, None),
                                              (None, 20), (1.0, 50)])
def test_snp_ldsc_matches_jax(intercept, blocks):
    rng = np.random.default_rng(1)
    M, N = 5000, 8000
    ld = rng.uniform(1, 50, M)
    chi2 = (rng.standard_normal(M) + np.sqrt(N * 0.3 * ld / M)) ** 2
    ref = jldsc.snp_ldsc(ld, M, chi2, N, blocks=blocks, intercept=intercept)
    got = pldsc.snp_ldsc(ld, M, chi2, N, blocks=blocks, intercept=intercept)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-10)


def test_snp_ldsc2_and_coef_to_liab_match_jax():
    jp = bt.snp_fake(400, 300, seed=4)
    jc = j_cor(jp, size=30)
    pc = to_port(jc.upper)
    rng = np.random.default_rng(2)
    df = {"beta": rng.normal(0, 0.05, 300), "beta_se": np.full(300, 0.05),
          "n_eff": np.full(300, 400.0)}
    for kw in (dict(), dict(blocks=10, intercept=None),
               dict(ind_beta=np.arange(0, 300, 2), blocks=None)):
        if "ind_beta" in kw:
            d = {k: v[kw["ind_beta"]] for k, v in df.items()}
        else:
            d = df
        ref = jldsc.snp_ldsc2(jc, d, **kw)
        got = pt.snp_ldsc2(pc, d, **kw)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-10)
    for K in (0.5, 0.1, 0.01):
        assert pt.coef_to_liab(K) == jldsc.coef_to_liab(K)


TOY = np.add.outer(np.arange(1, 5) / 10, np.arange(1, 5) / 10)
np.fill_diagonal(TOY, 1.0)


@pytest.mark.parametrize("kw", [
    dict(thr_r2=0, min_size=1, max_size=4, max_K=5, max_r2=1,
         max_cost=np.inf),
    dict(thr_r2=0, min_size=2, max_size=2, max_K=3, max_r2=1,
         max_cost=np.inf, pos_scaled=np.ones(4)),
    dict(thr_r2=0, min_size=1, max_size=3, max_K=3, max_r2=1,
         max_cost=np.inf, pos_scaled=np.linspace(0, 1, 4)),
    dict(thr_r2=0, min_size=1, max_size=3, max_K=4, max_r2=1,
         max_cost=np.inf, pos_scaled=np.arange(1, 5) * 2.0),
    dict(thr_r2=0, min_size=1, max_size=3, max_K=3, max_r2=1,
         max_cost=np.inf, pos_scaled=np.arange(1, 5) * 2.0),
])
def test_ldsplit_toy_exact(kw):
    """The reference's hand-computed toy cases (ties included)."""
    ref = j_ldsplit(sp.csc_matrix(TOY), **kw)
    got = pt.snp_ldsplit(sp.csc_matrix(TOY), **kw)
    assert same_split(got, ref)


@pytest.mark.parametrize("seed,kw", [
    (11, dict(thr_r2=0.02, min_size=5, max_size=(60, 120), max_K=40,
              max_r2=0.95, max_cost=np.inf)),
    (12, dict(thr_r2=0.0, min_size=3, max_size=30, max_K=60,
              max_r2=np.inf, max_cost=np.inf)),
])
def test_ldsplit_banded_exact(seed, kw):
    corr = banded(400, 25, seed)
    rng = np.random.default_rng(seed)
    kw = dict(kw, pos_scaled=np.cumsum(rng.random(400)) / 100)
    ref = j_ldsplit(JaxSparseLD(upper=sp.triu(sp.csc_matrix(corr)).tocsc()),
                    **kw)
    got = pt.snp_ldsplit(to_port(sp.triu(sp.csc_matrix(corr))), **kw)
    assert ref is not None and same_split(got, ref)
    for i in range(len(got["cost"])):
        assert len(block_num(got["all_size"][i])) == 400


def test_auto_blocks_exact_cuts_and_splits():
    rng = np.random.default_rng(3)
    mats = [np.corrcoef(np.cumsum(rng.normal(size=(s, s + 20)), axis=0))
            for s in (30, 50, 20)]
    up = sp.triu(sp.block_diag(mats).tocsc()).tocsc()
    jc, pc = JaxSparseLD(upper=up), to_port(up)
    for kw in (dict(max_block=4096), dict(max_block=40, min_size=5)):
        np.testing.assert_array_equal(pt.auto_blocks(pc, **kw),
                                      j_auto_blocks(jc, **kw))
    sub = np.r_[np.arange(0, 45), np.arange(50, 100)]
    np.testing.assert_array_equal(pt.auto_blocks(pc, ind_corr=sub),
                                  j_auto_blocks(jc, ind_corr=sub))


def test_auto_blocks_banded_ldsplit():
    m, W = 600, 25
    diags = [np.ones(m)] + [np.full(m - d, 0.8**d) for d in range(1, W + 1)]
    up = sp.diags(diags, list(range(W + 1)), format="csc").tocsc()
    jc, pc = JaxSparseLD(upper=up), to_port(up)
    got = pt.auto_blocks(pc, max_block=150, thr_r2=0.02)
    np.testing.assert_array_equal(got, j_auto_blocks(jc, max_block=150,
                                                     thr_r2=0.02))
    assert got.max() <= 150 and got.sum() == m
    assert pt.build_block_bands(pc, got).dropped_r2_frac < 0.05
