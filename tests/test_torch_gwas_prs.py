"""Port parity: snp_simuPheno, big_univLinReg, big_univLogReg,
gwas_pvalues, snp_PRS and snp_thr_correct against the JAX package.

Tolerances: the phenotype and the linear GWAS come from float32
products (rtol 1e-4, with atol tied to the scale of each column); the
logistic IRLS runs in float32 in the JAX package and float64 in the port
(rtol 1e-3); p-values and the winner's-curse correction are float64 host
math on the same inputs (rtol 1e-12)."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def to_port(jpack):
    return interop.pack_from_numpy(np.asarray(jpack.packed), jpack.n)


@pytest.fixture(scope="module")
def packs():
    jp = bt.snp_fake(301, 500, seed=3, na_prob=0.05)
    return jp, to_port(jp)


def close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("K,ind_row", [(None, None), (0.3, None),
                                       (None, np.arange(0, 301, 2))])
def test_simu_pheno_matches_jax(packs, K, ind_row):
    jp, pp = packs
    j = bt.snp_simuPheno(jp, 0.5, 20, K=K, ind_row=ind_row, seed=11)
    p = pt.snp_simuPheno(pp, 0.5, 20, K=K, ind_row=ind_row, seed=11)
    np.testing.assert_array_equal(p["set"], j["set"])
    close(p["effects"], j["effects"], 1e-5)
    close(p["allelic_effects"], j["allelic_effects"], 1e-5)
    if K is None:
        np.testing.assert_allclose(p["pheno"], j["pheno"], atol=1e-5)
        assert np.isclose(np.var(p["pheno"], ddof=1), 1.0)
    else:
        assert np.mean(p["pheno"] != j["pheno"]) < 0.01


@pytest.mark.parametrize("case", ["plain", "covar", "ind_row", "both"])
def test_linreg_matches_jax(packs, case):
    jp, pp = packs
    rng = np.random.default_rng(5)
    ind_row = np.sort(rng.choice(301, 200, replace=False)) \
        if case in ("ind_row", "both") else None
    n = 301 if ind_row is None else 200
    y = rng.standard_normal(n)
    covar = rng.standard_normal((n, 3)) if case in ("covar", "both") else None
    j = bt.big_univLinReg(jp, y, covar=covar, ind_row=ind_row)
    p = pt.big_univLinReg(pp, y, covar=covar, ind_row=ind_row)
    assert set(p) == {"estim", "std.err", "score"}
    close(p["estim"], j["estim"].to_numpy(), 1e-4)
    close(p["std.err"], j["std.err"].to_numpy(), 1e-4)
    close(p["score"], j["score"].to_numpy(), 1e-4)


def test_linreg_matches_dense_ols(packs):
    """Against plain float64 least squares with mean-imputed dosages."""
    jp, pp = packs
    rng = np.random.default_rng(8)
    y = rng.standard_normal(301)
    covar = rng.standard_normal((301, 2))
    p = pt.big_univLinReg(pp, y, covar=covar)
    X = jp.to_dosage()
    X = np.where(np.isnan(X), np.nanmean(X, 0), X)
    for j in (0, 17, 499):
        A = np.column_stack([np.ones(301), covar, X[:, j]])
        coef, rss, *_ = np.linalg.lstsq(A, y, rcond=None)
        se = np.sqrt(rss[0] / (301 - 4) * np.linalg.inv(A.T @ A)[-1, -1])
        np.testing.assert_allclose(p["estim"][j], coef[-1], rtol=1e-4)
        np.testing.assert_allclose(p["std.err"][j], se, rtol=1e-4)


def test_logreg_matches_jax(packs):
    jp, pp = packs
    rng = np.random.default_rng(6)
    y01 = (rng.random(301) < 0.4).astype(int)
    covar = rng.standard_normal((301, 2))
    for kw in ({}, {"covar": covar}):
        j = bt.big_univLogReg(jp, y01, **kw)
        p = pt.big_univLogReg(pp, y01, block=64, **kw)
        close(p["estim"], j["estim"].to_numpy(), 1e-3)
        close(p["std.err"], j["std.err"].to_numpy(), 1e-3)
    ir = np.arange(0, 301, 3)
    j = bt.big_univLogReg(jp, y01[ir], ind_row=ir)
    p = pt.big_univLogReg(pp, y01[ir], ind_row=ir)
    close(p["estim"], j["estim"].to_numpy(), 1e-3)


def test_gwas_pvalues_match_jax(packs):
    jp, pp = packs
    y = np.random.default_rng(2).standard_normal(301)
    j = bt.big_univLinReg(jp, y)
    from bigsnpr_tpu.assoc.gwas import gwas_pvalues as j_pvalues

    for log10 in (False, True):
        np.testing.assert_allclose(pt.gwas_pvalues(j, log10=log10),
                                   j_pvalues(j, log10=log10), rtol=1e-12)


@pytest.mark.parametrize("flip", [False, True])
def test_prs_matches_jax(packs, flip):
    jp, pp = packs
    rng = np.random.default_rng(4)
    ind_test = np.sort(rng.choice(301, 120, replace=False))
    ind_keep = rng.choice(500, 300, replace=False)          # unique
    betas = rng.standard_normal(300) * 0.1
    lpS = rng.exponential(1.0, 300)
    same = rng.random(300) < (0.7 if flip else 1.0)
    thr = [0.0, 0.5, 1.0, 2.0]
    j = bt.snp_PRS(jp, betas, ind_test=ind_test, ind_keep=ind_keep,
                   same_keep=same, lpS_keep=lpS, thr_list=thr)
    p = pt.snp_PRS(pp, betas, ind_test=ind_test, ind_keep=ind_keep,
                   same_keep=same, lpS_keep=lpS, thr_list=thr)
    assert p.shape == (120, 4)
    close(p, j, 1e-4)
    # no thresholds: one column of prodVecRev
    j0 = bt.snp_PRS(jp, betas, ind_test=ind_test, ind_keep=ind_keep,
                    same_keep=same)
    p0 = pt.snp_PRS(pp, betas, ind_test=ind_test, ind_keep=ind_keep,
                    same_keep=same)
    close(p0, j0, 1e-4)
    close(p0[:, 0], p[:, 0], 1e-4)      # threshold 0 keeps lpS > 0: all


def test_thr_correct_matches_jax():
    from bigsnpr_tpu.pgs.prs import snp_thr_correct as j_thr

    rng = np.random.default_rng(3)
    beta = rng.standard_normal(200) * 0.05
    se = np.full(200, 0.02)
    for kw in ({"beta_se": se, "thr_lpS": 1.3}, {"beta_se": se, "thr_lpS": 0},
               {"lpS": -np.log10(rng.random(200)), "thr_lpS": 2.0}):
        np.testing.assert_allclose(pt.snp_thr_correct(beta, **kw),
                                   j_thr(beta, **kw), rtol=1e-12)
    with pytest.raises(ValueError):
        pt.snp_thr_correct(beta, thr_lpS=1.0)
