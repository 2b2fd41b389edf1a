"""Slice 6c end to end: the chain of chip_smoke.py [19] at a small size
through both packages on one BGEN file written by the chip script's own
cohort writer (`bgen_cohort`: slice 2's LD generator turned into 8-bit
imputation-like probabilities). Each stage is held against the JAX
package's at the tolerance of its parity test (tests/test_torch_dosage.py,
tests/test_torch_bgen.py); LDpred2-grid (a Monte-Carlo sampler) is run in
the port alone. The port-only run of [19] with jax, pandas, pyarrow and
the JAX package blocked is in tests/test_torch_slice6.py's subprocess.
Its own file, so that `--dist loadfile` gives it another worker."""

import os
import sys

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core.dosage import DosagePack as JaxDosagePack
from bigsnpr_tpu.io import bgen as jbgen
import bigsnpr_tpu_torch as pt

from oracle_native import private_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    yield from private_native(tmp_path_factory)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def pair_r64(X):
    """Pairwise-complete Pearson r of every pair of columns of X (NaN =
    missing) in float64, from the six NA-aware sums."""
    mk = (~np.isnan(X)).astype(np.float64)
    x = np.nan_to_num(X)
    Sxy, Sx, Sxx, Np = x.T @ x, x.T @ mk, (x * x).T @ mk, mk.T @ mk
    num = Sxy - Sx * Sx.T / Np
    return num / np.sqrt((Sxx - Sx * Sx / Np) * (Sxx.T - Sx.T * Sx.T / Np))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_slice6c_chain_matches_jax(tmp_path):
    args = chip_smoke.arg_parser().parse_args(
        ["--n7", "320", "--m7", "900", "--bmin", "60", "--bmax", "150",
         "--seed", "3"])
    path = str(tmp_path / "c.bgen")
    _, ids, _, _, _, _ = chip_smoke.bgen_cohort(torch, torch.device("cpu"),
                                                args, path)
    n = args.n7
    a = jbgen.snp_readBGI(path + ".bgi")
    b = pt.snp_readBGI(path + ".bgi")
    assert all(a[k].tolist() == b[k].tolist() for k in b)
    jp = jbgen.snp_readBGEN(path, [ids])
    pp = pt.snp_readBGEN(path, [ids])
    assert np.array_equal(pp.codes, jp.codes)
    np.testing.assert_allclose(pp.map["info"], jp.map["info"].to_numpy(),
                               atol=1e-12, equal_nan=True)
    rj = jbgen.snp_readBGEN(path, [ids[:200]], read_as="random", seed=3)
    rp = pt.snp_readBGEN(path, [ids[:200]], read_as="random", seed=3)
    assert np.array_equal(rp.packed, rj.packed)

    # QC, scaling, randomSVD on the byte path
    maf_j, maf_p = bt.snp_MAF(jp), pt.snp_MAF(pp)
    np.testing.assert_allclose(maf_p, maf_j, rtol=1e-12)
    keep = np.flatnonzero((maf_p > 0.01) & (pp.map["info"] > 0.3))
    assert np.array_equal(keep, np.flatnonzero(
        (maf_j > 0.01) & (jp.map["info"].to_numpy() > 0.3)))
    jq, pq = jp.subset(ind_col=keep), pp.subset(ind_col=keep, device="cpu")
    scj, scp = bt.snp_scaleBinom()(jq), pt.snp_scaleBinom()(pq)
    np.testing.assert_allclose(scp["scale"], scj["scale"], rtol=1e-12)
    sj = bt.snp_randomSVD(jq, fun_scaling=bt.snp_scaleBinom(), k=3, tol=1e-6)
    sp = pt.snp_randomSVD(pq, fun_scaling=pt.snp_scaleBinom(), k=3, tol=1e-6)
    np.testing.assert_allclose(sp.d, sj.d, rtol=1e-4)

    # phenotype through snp_prodVec, marginal statistics through cprodVec
    rng = np.random.default_rng(1)
    mq = len(keep)
    beta = np.zeros(mq)
    beta[rng.choice(mq, 60, replace=False)] = rng.standard_normal(60)
    gj = np.asarray(bt.snp_prodVec(jq, beta, scj["center"], scj["scale"]))
    gp = pt.snp_prodVec(pq, beta, scp["center"], scp["scale"])
    assert rel(gp, gj) <= 1e-5
    y = gp / gp.std() * np.sqrt(0.4) + rng.normal(0, np.sqrt(0.6), n)
    train = np.setdiff1d(np.arange(n), np.arange(0, n, 4))
    test = np.arange(0, n, 4)
    b, se, z = chip_smoke.marginal_stats(pt, pq, y, train)
    sub_j = jq.subset(ind_row=train)
    st = bt.snp_colstats(sub_j)
    c, s = st["sumX"] / st["nona"], np.sqrt(st["denoX"] / st["nona"])
    xty = np.asarray(bt.snp_cprodVec(sub_j, y[train] - y[train].mean(), c,
                                     s), np.float64)
    assert rel(b, xty / (st["denoX"] / s**2) / s) <= 1e-5
    df_beta = {"beta": b, "beta_se": se, "n_eff": np.full(mq, len(train))}

    # LD, LDSC, LDpred2-grid, C+T, LD scores
    cj = bt.snp_cor(jq, ind_row=train, size=100, thr_r2=0.01)
    cp = pt.snp_cor(pq, ind_row=train, size=100, thr_r2=0.01)
    Dj, Dp = cj.to_dense(), cp.to_dense()
    assert np.array_equal(Dj != 0, Dp != 0)
    # the port's float64 pair sums against float64 r on the decoded
    # dosages (1e-9), the JAX package's float32 ones within their own
    # float32 error (5e-5: 1.7e-5 off float64 here, on low-variance pairs)
    R = pair_r64(jq.subset(ind_row=train).to_dosage())
    ii, jj = np.nonzero(np.triu(Dp, 1))
    assert np.abs(Dp[ii, jj] - R[ii, jj]).max() <= 1e-9
    assert np.abs(Dj - Dp).max() <= 5e-5
    hj = bt.snp_ldsc2(cj, df_beta)["h2"]
    hp = pt.snp_ldsc2(cp, df_beta)["h2"]
    assert abs(hp - hj) <= 1e-4 * abs(hj)
    bb = pt.build_block_bands(cp, pt.auto_blocks(cp))
    h2 = max(float(hp), 1e-3)
    grid = {"p": [0.01, 0.1], "h2": [h2, h2], "sparse": [False, False]}
    bg = pt.snp_ldpred2_grid(cp, df_beta, grid, burn_in=5, num_iter=5,
                             blocks=bb)
    assert bg.shape == (mq, 2) and np.isfinite(bg).all()
    kj = bt.snp_clumping(jq, ind_row=train, S=np.abs(z), thr_r2=0.2)
    kp = pt.snp_clumping(pq, ind_row=train, S=np.abs(z), thr_r2=0.2)
    assert np.array_equal(kp, kj)
    lpS = -np.log10(np.maximum(2 * (1 - 0.5 * (1 + np.tanh(
        0.7978845608 * np.abs(z)))), 1e-300))
    thr = np.linspace(0, np.quantile(lpS[kp], 0.99), 5)
    prs_j = np.asarray(bt.snp_PRS(jq, b[kp], ind_test=test, ind_keep=kp,
                                  lpS_keep=lpS[kp], thr_list=thr))
    prs_p = pt.snp_PRS(pq, b[kp], ind_test=test, ind_keep=kp,
                       lpS_keep=lpS[kp], thr_list=thr)
    assert rel(prs_p, prs_j) <= 1e-5
    # LD scores: 1 + the r^2 of the 100 neighbours each side, float64
    near = np.abs(np.subtract.outer(np.arange(mq), np.arange(mq))) <= 100
    ld64 = 1 + np.where(near & ~np.eye(mq, dtype=bool), R * R, 0).sum(1)
    ld_p = pt.snp_ld_scores(pq, ind_row=train, size=100)
    ld_j = bt.snp_ld_scores(jq, ind_row=train, size=100)
    assert np.abs(ld_p - ld64).max() <= 1e-9 * ld64.max()
    # the JAX package's float32 sums: 1.5e-5 of max here
    assert np.abs(ld_j - ld_p).max() <= 5e-5 * ld64.max()

    # snp_prodBGEN, hard calls, the store
    ids_q = [ids[j] for j in keep]
    wj = jbgen.snp_prodBGEN(path, bg[:, 0], ids_q, engine="host")
    wp = pt.snp_prodBGEN(path, bg[:, 0], ids_q, engine="host")
    ok = ~np.isnan(wj)
    assert np.array_equal(ok, ~np.isnan(wp))
    assert np.abs(wp - wj)[ok].max() <= 1e-12 * np.abs(wj[ok]).max()
    wd = pt.snp_prodBGEN(path, bg[:, 0], ids_q, engine="device")
    np.testing.assert_allclose(wd, wj, rtol=5e-6, atol=5e-6, equal_nan=True)
    hj, hp = jq.round_to_hardcalls(), pq.round_to_hardcalls()
    assert np.array_equal(hp.packed, hj.packed)
    sj = np.asarray(bt.snp_PRS(hj, bg[:, 0], ind_test=test))
    sp = pt.snp_PRS(hp, bg[:, 0], ind_test=test)
    assert rel(sp, sj) <= 1e-5
    back = JaxDosagePack.load(pt.DosagePack(
        codes=pp.codes, n=pp.n).save(tmp_path / "c"), mmap=False)
    assert np.array_equal(back.codes, jp.codes)
