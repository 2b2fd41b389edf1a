"""Port parity: the unblocked samplers (`blocks=None`), which walk one band
over every variant: snp_ldpred2_grid / snp_ldpred2_auto /
return_sampling_betas / snp_lassosum2 against the JAX package's
`gibbs_one`, `gibbs_auto`, `gibbs_one_sampling` and `lassosum_cd`.

On the CPU the sweep runs its plain twin on the one-block bands
(`band.one_block_bands`). Tolerances:
- one sweep, the twin against the JAX package's `_sweep_gibbs` on the same
  state and pre-drawn u / z, with and without an `ind_corr` subset:
  float32 round-off (rtol 1e-5, atol 1e-6; `causal` equal), float64 1e-12;
- lassosum2, deterministic: float32 bit-equal (both packages fuse the
  dp update's multiply-add and round dp1 twice), float64 within 1e-12 of
  max |beta|, num_iter equal;
- the samplers draw from other generators (Philox per chain against
  threefry), so they agree at Monte-Carlo level, as tests/test_blocked.py
  holds the JAX package's blocked samplers against its unblocked ones:
  r(beta) > 0.95, h2 within 35%;
- unblocked against blocked in the port, on block-diagonal LD: the same
  per-chain streams and the same rows, so the grid and lassosum2 agree to
  round-off."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from bigsnpr_tpu.ops.corr import SparseLD as JaxSparseLD
from bigsnpr_tpu.pgs import gibbs as jgibbs
from bigsnpr_tpu.pgs import ldpred2 as jl
from bigsnpr_tpu.pgs.band import build_band as j_build_band
from bigsnpr_tpu.pgs.lassosum2 import snp_lassosum2 as j_lassosum2
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import gibbs_kernels as gk
from bigsnpr_tpu_torch.pgs.band import one_block_bands

torch.set_num_threads(2)
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6),
       np.float64: dict(rtol=1e-12, atol=1e-14)}


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def blockdiag(seed=8, sizes=(40, 25, 60, 35), inflate=1.0):
    """tests/test_blocked.py's block-diagonal LD and sumstats; `inflate`
    scales the off-diagonal entries (> 1 makes the matrix indefinite)."""
    rng = np.random.default_rng(seed)
    m = sum(sizes)
    mats = []
    for sz in sizes:
        A = rng.normal(size=(sz, sz + 30))
        C = np.corrcoef(np.cumsum(A, axis=0)) * inflate
        np.fill_diagonal(C, 1.0)
        mats.append(C)
    up = sp.triu(sp.block_diag(mats).tocsc()).tocsc()
    beta = rng.normal(0, 0.05, m)
    df_beta = {"beta": beta, "beta_se": np.full(m, 0.05),
               "n_eff": rng.uniform(8000, 12000, m)}
    port = interop.sparse_ld_from_numpy(up.data, up.indices, up.indptr,
                                        up.shape)
    return JaxSparseLD(upper=up), port, df_beta, np.asarray(sizes)


def consistent(seed=8, sizes=(40, 25, 60, 35), n=10000, h2=0.3, M=15,
               rho=0.7):
    """Block-diagonal AR(1) LD (lag-k correlation rho^k inside a block)
    and marginal effects drawn from it: bh = R b + e, e ~ N(0, R / n), b
    with M causal variants of total variance h2, handed over as
    standardized betas (scale 1)."""
    mats = [rho ** np.abs(np.subtract.outer(np.arange(sz), np.arange(sz)))
            for sz in sizes]
    R = sp.block_diag(mats).toarray()
    up = sp.triu(sp.csc_matrix(R)).tocsc()
    m = R.shape[0]
    rng = np.random.default_rng(seed)
    b = np.zeros(m)
    b[rng.choice(m, M, replace=False)] = rng.normal(0, np.sqrt(h2 / M), M)
    bh = R @ b + np.linalg.cholesky(R) @ rng.normal(size=m) / np.sqrt(n)
    df = {"beta": bh, "beta_se": np.sqrt((1 - bh**2) / n),
          "n_eff": np.full(m, float(n))}
    port = interop.sparse_ld_from_numpy(up.data, up.indices, up.indptr,
                                        up.shape)
    return JaxSparseLD(upper=up), port, df, np.asarray(sizes)


def banded_corr(m=180, width=12, seed=2):
    """Banded AR-like LD with no exact block cut (one LD component)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.5, 0.9, m)
    diags, offs = [np.ones(m)], [0]
    for d in range(1, width + 1):
        diags.append(np.prod([rho[i:m - d + i] for i in range(d)], axis=0)
                     * rng.uniform(0.9, 1.0, m - d))
        offs.append(d)
    up = sp.diags(diags, offs, format="csc").tocsc()
    return JaxSparseLD(upper=up), interop.sparse_ld_from_numpy(
        up.data, up.indices, up.indptr, up.shape)


def test_one_block_bands_are_the_subset_band():
    """One bucket of one block holding every variant of the subset; its
    rows are the JAX package's band[ind_corr] restricted to the subset."""
    jc, pc = banded_corr()
    ind = np.sort(np.random.default_rng(0).choice(180, 120, replace=False))
    bb = one_block_bands(pc, ind)
    (bands, gidx), = bb.buckets
    np.testing.assert_array_equal(gidx, np.arange(120)[None])
    assert bb.m == 120 and bb.dropped_r2 == 0.0
    jband, JW = j_build_band(jc)
    W = (bands.shape[2] - 1) // 2
    dense_j = np.zeros((180, 180), np.float32)
    rows, cols = np.nonzero(jband)
    dense_j[rows, rows + cols - JW] = jband[rows, cols]
    sub = dense_j[ind][:, ind]
    got = np.zeros((120, 120 + 2 * W), np.float32)
    for j in range(120):
        got[j, j:j + 2 * W + 1] = bands[0, j]
    np.testing.assert_array_equal(got[:, W:W + 120], sub)
    assert not got[:, :W].any() and not got[:, W + 120:].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("subset", [False, True])
def test_one_block_sweep_matches_jax_sweep_gibbs(dtype, subset):
    """One sweep of 3 chains on the one-block bands (the twin) against the
    JAX package's `_sweep_gibbs` chain by chain, on the same state and the
    same pre-drawn u / z; dp compared at the subset's positions."""
    jc, pc = banded_corr()
    m2 = 180
    ind = (np.sort(np.random.default_rng(1).choice(m2, 130, replace=False))
           if subset else np.arange(m2))
    m, NC = len(ind), 3
    rng = np.random.default_rng(5)
    st = dict(bh=rng.normal(0, 0.05, m), C2=rng.uniform(0.1, 0.9, (NC, m)),
              C4=rng.uniform(0.1, 0.9, (NC, m)),
              s1=rng.uniform(1.0, 2.0, (NC, m)),
              u=rng.uniform(0, 1, (NC, m)), z=rng.normal(0, 1, (NC, m)),
              cb=rng.normal(0, 0.05, (NC, m)) * (rng.random((NC, m)) < 0.5))
    st = {k: v.astype(dtype) for k, v in st.items()}
    iop = np.array([4.0, 9.0, 1.5], dtype)
    p = np.array([0.2, 0.1, 0.4], dtype)
    sparse = np.array([False, True, False])
    jband, JW = j_build_band(jc, dtype=dtype)
    jdp = rng.normal(0, 0.05, (NC, m2 + 2 * JW)).astype(dtype)
    sb = one_block_bands(pc, ind if subset else None, dtype).device_put(
        "cpu", dtype=dtype)
    W = sb.wkmax // 2
    dp = rng.normal(0, 0.05, (NC, sb.dp_len)).astype(dtype)
    dp[:, W:W + m] = jdp[:, ind + JW]                 # the centres agree
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    tdp = T(dp)
    shrink, no_jump = 0.95, True
    out = gk.sweep(sb, tdp, T(st["cb"]), T(st["bh"]), T(st["C2"]),
                   T(st["C4"]), T(st["s1"]), T(st["u"]), T(st["z"]), T(iop),
                   T(p), T(sparse), shrink, no_jump)
    assert gk.launches["sweep"] == gk.launches["sweep_global"] == 0
    nb, causal, postp, binc, dps, h2_inc, gap = (o.numpy() for o in out)
    tol = TOL[dtype]
    ctx = jax.enable_x64(True) if dtype == np.float64 else None
    if ctx:
        ctx.__enter__()
    try:
        for c in range(NC):
            a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
            dp_j, nb_j, aux = jgibbs._sweep_gibbs(
                a(jdp[c]), a(st["cb"][c]), a(jband[ind]),
                jnp.asarray(ind, jnp.int32), a(st["bh"]), a(st["C2"][c]),
                a(st["C4"][c]), a(st["s1"][c]), a(iop[c]), a(p[c]),
                bool(sparse[c]), a(shrink), no_jump, a(st["u"][c]),
                a(st["z"][c]), JW)
            gap_j, causal_j, h2_j, postp_j, binc_j, dps_j = aux
            np.testing.assert_array_equal(causal[c], np.asarray(causal_j))
            for got, ref in ((nb[c], nb_j), (postp[c], postp_j),
                             (binc[c], binc_j), (dps[c], dps_j)):
                np.testing.assert_allclose(got, np.asarray(ref), **tol)
            np.testing.assert_allclose(tdp.numpy()[c, W:W + m],
                                       np.asarray(dp_j)[ind + JW], **tol)
            np.testing.assert_allclose(h2_inc[c], float(h2_j),
                                       rtol=tol["rtol"] * 10, atol=1e-12)
            np.testing.assert_allclose(gap[c], float(gap_j),
                                       rtol=tol["rtol"] * 10)
    finally:
        if ctx:
            ctx.__exit__(None, None, None)


def compare_lasso(jres, pres, tol):
    jb, jg = jres
    pb, pg = pres
    np.testing.assert_array_equal(pg["num_iter"], jg["num_iter"].to_numpy())
    for key in ("lambda", "delta", "sparsity"):
        np.testing.assert_array_equal(pg[key], jg[key].to_numpy())
    np.testing.assert_array_equal(np.isnan(pb), np.isnan(jb))
    ok = np.isfinite(jb)
    assert np.abs(pb[ok] - jb[ok]).max() <= tol * np.abs(jb[ok]).max()


@pytest.mark.parametrize("dtype,tol", [("float32", 0.0), ("float64", 1e-12)])
def test_lassosum2_unblocked_matches_jax(dtype, tol):
    jc, pc = banded_corr(m=200, width=15, seed=4)
    rng = np.random.default_rng(4)
    df = {"beta": rng.normal(0, 0.05, 200), "beta_se": np.full(200, 0.05),
          "n_eff": rng.uniform(8000, 12000, 200)}
    kw = dict(nlambda=8, maxiter=300, dtype=dtype)
    jres = j_lassosum2(jc, df, **kw)
    pres = pt.snp_lassosum2(pc, df, **kw)
    assert gk.launches["lassosum"] == gk.launches["lassosum_global"] == 0
    compare_lasso(jres, pres, tol)
    assert (pres[1]["num_iter"] < 300).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 0.0), ("float64", 1e-12)])
def test_lassosum2_unblocked_stopping_rules_match_jax(dtype, tol):
    """Indefinite LD: the low-delta points diverge (NaN), a small dfmax
    stops the dense end, maxiter caps the rest, as in the JAX package; with
    an ind_corr subset."""
    jc, pc, df, sizes = blockdiag(seed=3, inflate=1.6)
    ind = np.arange(0, sizes.sum(), 4)
    dsub = {k: np.asarray(v)[ind] for k, v in df.items()}
    kw = dict(nlambda=6, maxiter=60, dfmax=25, delta=(1e-4, 0.05, 2.0),
              dtype=dtype, ind_corr=ind)
    pres = pt.snp_lassosum2(pc, dsub, **kw)
    compare_lasso(j_lassosum2(jc, dsub, **kw), pres, tol)
    assert np.isnan(pres[0]).any() and (pres[1]["num_iter"] < 60).any()


def test_unblocked_equals_blocked_on_blockdiag():
    """On block-diagonal LD the one-block walk is the blocked one: the same
    rows in the same order and the same per-chain draws, so the grid's
    betas and lassosum2's agree to round-off (the per-block sums of h2 and
    gap are added in another order)."""
    _, pc, df, sizes = consistent()
    grid = {"p": [0.2, 1.0, 0.05], "h2": [0.3, 0.3, 0.5],
            "sparse": [False, False, True]}
    kw = dict(burn_in=20, num_iter=30)
    un = pt.snp_ldpred2_grid(pc, df, grid, **kw)
    bl = pt.snp_ldpred2_grid(pc, df, grid, blocks=sizes, **kw)
    assert np.isfinite(un).all()
    np.testing.assert_allclose(un, bl, rtol=1e-5, atol=1e-9)
    lb, lg = pt.snp_lassosum2(pc, df, nlambda=6, maxiter=200)
    bb, bg = pt.snp_lassosum2(pc, df, nlambda=6, maxiter=200, blocks=sizes)
    np.testing.assert_array_equal(lg["num_iter"], bg["num_iter"])
    np.testing.assert_allclose(lb, bb, rtol=1e-6, atol=1e-12,
                               equal_nan=True)


def test_grid_unblocked_statistical_vs_jax():
    jc, pc, df, _ = consistent()
    grid = {"p": [0.2, 0.1], "h2": [0.3, 0.3], "sparse": [False, True]}
    kw = dict(burn_in=50, num_iter=300)
    got = pt.snp_ldpred2_grid(pc, df, grid, **kw)
    ref = jl.snp_ldpred2_grid(jc, df, grid, **kw)
    assert got.shape == ref.shape == (160, 2) and np.isfinite(got).all()
    for c in range(2):
        assert np.corrcoef(got[:, c], ref[:, c])[0, 1] > 0.95
    assert np.mean(got[:, 1] == 0) > 0.2 and np.mean(got[:, 0] == 0) == 0


def test_auto_unblocked_statistical_vs_jax():
    """LDpred2-auto with sparse=True: the result keys of the JAX package's
    unblocked branch (no dropped_r2_frac), beta_est and the post-hoc
    sparse solution within Monte-Carlo noise of its own, h2 within 35%."""
    jc, pc, df, _ = blockdiag()
    kw = dict(h2_init=0.2, vec_p_init=[0.2, 0.05], burn_in=150,
              num_iter=150, use_MLE=False, sparse=True, report_step=50)
    got = pt.snp_ldpred2_auto(pc, df, **kw)
    ref = jl.snp_ldpred2_auto(jc, df, **kw)
    for r, j in zip(got, ref):
        assert set(r) == set(j) and "dropped_r2_frac" not in r
        assert np.isfinite(r["beta_est"]).all()
        assert np.corrcoef(r["beta_est"], j["beta_est"])[0, 1] > 0.95
        assert abs(r["h2_est"] - j["h2_est"]) < 0.35 * max(j["h2_est"], 0.1)
        bs = r["beta_est_sparse"]
        assert np.isfinite(bs).all() and (bs == 0).any()
        assert np.corrcoef(bs, j["beta_est_sparse"])[0, 1] > 0.95
        assert r["sample_beta"].shape == j["sample_beta"].shape == (3, 160)
        assert r["path_h2_est"].shape == (300,)
    # the README quick start's call: every default, blocks=None
    _, pc, df, _ = consistent()
    quick = pt.snp_ldpred2_auto(pc, df, 0.2, burn_in=20, num_iter=20)
    assert len(quick) == 1 and np.isfinite(quick[0]["beta_est"]).all()


def test_sampling_betas_statistical_vs_jax():
    """return_sampling_betas: (m, num_iter) samples of the unblocked
    sampler whatever `blocks`; their mean is the posterior mean of the
    grid model, within Monte-Carlo noise of the JAX package's."""
    jc, pc, df, sizes = consistent()
    grid = {"p": [0.3], "h2": [0.3], "sparse": [False]}
    kw = dict(burn_in=50, num_iter=300, return_sampling_betas=True)
    got = pt.snp_ldpred2_grid(pc, df, grid, **kw)
    again = pt.snp_ldpred2_grid(pc, df, grid, blocks=sizes, **kw)
    ref = jl.snp_ldpred2_grid(jc, df, grid, **kw)
    assert got.shape == ref.shape == (160, 300) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, again)
    assert np.corrcoef(got.mean(1), ref.mean(1))[0, 1] > 0.95
    np.testing.assert_allclose(got.std(1).mean(), ref.std(1).mean(),
                               rtol=0.1)
    mean = pt.snp_ldpred2_grid(pc, df, grid, burn_in=50, num_iter=300)
    assert np.corrcoef(got.mean(1), mean[:, 0])[0, 1] > 0.95
