"""Port parity: LDpred2 (inf, grid, auto) and chain QC against the JAX
package, on one LD-structured pipeline (haplotype-copying genotypes, a
simulated trait, marginal effects, snp_cor LD, auto_blocks).

The two packages draw from different generators (torch Philox per chain,
JAX threefry), so the samplers agree at Monte-Carlo level, as
tests/test_pgs.py and tests/test_multichain.py hold the JAX package's own:
corrcoef of the auto beta_est with JAX's > 0.9 and h2_est / p_est within
those tests' bounds; per grid cell, on a long run (1,000 sweeps kept),
r(X beta, y) within rtol 2e-3 of JAX's (the effect vectors themselves
carry ~4% Monte-Carlo noise at that length). snp_ldpred2_inf is a
deterministic sparse solve: within 1e-10."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.ops.corr import snp_cor as j_cor
from bigsnpr_tpu.pgs import gibbs as jgibbs
from bigsnpr_tpu.pgs import ldpred2 as jl
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.pgs import gibbs as pgibbs
from bigsnpr_tpu_torch.pgs import gibbs_blocked as pgb

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


@pytest.fixture(scope="module")
def pipe():
    rng = np.random.default_rng(42)
    n, m = 2000, 300
    p = rng.uniform(0.1, 0.5, m)
    hap = np.empty((2 * n, m), dtype=np.int8)
    hap[:, 0] = rng.random(2 * n) < p[0]
    for j in range(1, m):
        copy = rng.random(2 * n) < 0.8
        hap[:, j] = np.where(copy, hap[:, j - 1], rng.random(2 * n) < p[j])
    X = (hap[:n] + hap[n:]).astype(float)
    Xs = (X - X.mean(0)) / X.std(0)
    beta = np.zeros(m)
    causal = rng.choice(m, 30, replace=False)
    beta[causal] = rng.normal(0, np.sqrt(0.5 / 30), 30)
    g = Xs @ beta
    y = g + rng.normal(0, np.sqrt(1 - g.var()), n)
    yc = y - y.mean()
    b = Xs.T @ yc / n
    se = np.sqrt(((yc[:, None] - Xs * b) ** 2).sum(0) / (n - 2) / n)
    df = {"beta": b, "beta_se": se, "n_eff": np.full(m, float(n))}
    pack = JaxGenoPack(packed=junpack.np_pack_codes(
        junpack.np_dosage_to_codes(X.T)), n=n)
    jc = j_cor(pack, size=50)
    u = jc.upper
    pc = interop.sparse_ld_from_numpy(u.data, u.indices, u.indptr, u.shape)
    blocks = pt.auto_blocks(pc, max_block=100)
    return dict(X=X, y=y, df=df, jc=jc, pc=pc, blocks=blocks, m=m)


def r_pred(pipe, beta):
    return np.corrcoef(pipe["X"] @ beta, pipe["y"])[0, 1]


def test_grid_matches_jax_long_run(pipe):
    grid = {"p": [0.1, 0.1, 1.0], "h2": [0.5, 0.5, 0.5],
            "sparse": [False, True, False]}
    kw = dict(burn_in=100, num_iter=1000, blocks=pipe["blocks"])
    got = pt.snp_ldpred2_grid(pipe["pc"], pipe["df"], grid, **kw)
    ref = jl.snp_ldpred2_grid(pipe["jc"], pipe["df"], grid, **kw)
    assert got.shape == ref.shape == (pipe["m"], 3)
    assert np.isfinite(got).all()
    for c in range(3):
        np.testing.assert_allclose(r_pred(pipe, got[:, c]),
                                   r_pred(pipe, ref[:, c]), rtol=2e-3)
        assert np.corrcoef(got[:, c], ref[:, c])[0, 1] > 0.99
    assert np.mean(got[:, 1] == 0) > 0.2 and np.mean(got[:, 0] == 0) == 0


def test_auto_matches_jax(pipe):
    kw = dict(h2_init=0.3, vec_p_init=[0.1, 0.5], burn_in=200, num_iter=200,
              report_step=50, blocks=pipe["blocks"])
    got = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], **kw)
    ref = jl.snp_ldpred2_auto(pipe["jc"], pipe["df"], **kw)
    assert len(got) == 2
    for r, j in zip(got, ref):
        assert set(r) == set(j)
        assert np.isfinite(r["beta_est"]).all()
        assert np.corrcoef(r["beta_est"], j["beta_est"])[0, 1] > 0.9
        assert r_pred(pipe, r["beta_est"]) > 0.5
        assert 0.05 < r["h2_est"] < 1.5 and 0 < r["p_est"] < 1
        assert abs(r["h2_est"] - j["h2_est"]) < 0.35 * max(j["h2_est"], 0.1)
        assert -1.5 <= r["alpha_est"] <= 0.5
        np.testing.assert_allclose(r["h2_est"],
                                   np.mean(r["path_h2_est"][-200:]),
                                   rtol=1e-6)
        assert r["sample_beta"].shape == (4, pipe["m"])
        assert r["dropped_r2_frac"] == j["dropped_r2_frac"]
    keep, beta = pt.ldpred2_auto_chain_qc(got)
    jkeep, jbeta = jl.ldpred2_auto_chain_qc(got)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(beta, jbeta)


def test_auto_h2_path_is_beta_R_beta(pipe):
    """path_h2_est at a report == s' R s of that report's sampled betas
    (reference test-8-LDpred2.R:105-106): the kernel's h2_inc tracking."""
    burn_in, num_iter, step = 60, 60, 20
    res = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], h2_init=0.4,
                              vec_p_init=[0.2], burn_in=burn_in,
                              num_iter=num_iter, report_step=step,
                              use_MLE=False, blocks=pipe["blocks"])[0]
    bb = pt.build_block_bands(pipe["pc"], pipe["blocks"])
    R = np.zeros((pipe["m"], pipe["m"]))
    for bands, gidx in bb.buckets:
        W = (bands.shape[2] - 1) // 2
        for b in range(bands.shape[0]):
            g = gidx[b][gidx[b] >= 0]
            for jj, gj in enumerate(g):
                for d in range(-W, W + 1):
                    if 0 <= jj + d < len(g):
                        R[gj, g[jj + d]] = bands[b, jj, W + d]
    for t in range(num_iter // step):
        k = burn_in + (t + 1) * step - 1
        s = res["sample_beta"][t]
        np.testing.assert_allclose(res["path_h2_est"][k], s @ R @ s,
                                   rtol=5e-3, atol=1e-4)


def test_auto_sparse_and_float64(pipe):
    res = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], h2_init=0.3,
                              vec_p_init=[0.2], burn_in=50, num_iter=50,
                              sparse=True, use_MLE=False,
                              allow_jump_sign=False, blocks=pipe["blocks"])
    bs = res[0]["beta_est_sparse"]
    assert np.isfinite(bs).all() and (bs == 0).any()
    assert np.corrcoef(bs, res[0]["beta_est"])[0, 1] > 0.8
    r64 = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], h2_init=0.3,
                              vec_p_init=[0.2], burn_in=50, num_iter=50,
                              blocks=pipe["blocks"], dtype="float64")[0]
    assert np.isfinite(r64["beta_est"]).all() and 0 < r64["h2_est"] < 2


def test_ldpred2_inf_matches_jax(pipe):
    for h2 in (0.1, 0.4):
        np.testing.assert_allclose(
            pt.snp_ldpred2_inf(pipe["pc"], pipe["df"], h2),
            jl.snp_ldpred2_inf(pipe["jc"], pipe["df"], h2),
            rtol=1e-10, atol=1e-10)


def test_unported_options_raise(pipe):
    """The sharding options keep the JAX package's assertions:
    shard_chains needs blocks= and excludes shard_blocks, and the chain
    count must divide the shards (AssertionError in both packages);
    shard_blocks without blocks= raises ValueError in the port, where the
    JAX package ignores it. blocks=None and return_sampling_betas run
    since slice 5 (tests/test_torch_unblocked.py holds them against the
    JAX package)."""
    blocks, cpu3 = pipe["blocks"], ["cpu"] * 3
    for kw, err in ((dict(shard_chains=True), AssertionError),
                    (dict(blocks=blocks, shard_chains=True,
                          shard_blocks=True), AssertionError),
                    (dict(blocks=blocks, shard_chains=True, mesh=cpu3,
                          vec_p_init=[0.1, 0.2]), AssertionError),
                    (dict(shard_blocks=True), ValueError)):
        with pytest.raises(err):
            pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], h2_init=0.3,
                                burn_in=2, num_iter=2, **kw)
    for kw in (dict(shard_chains=True),
               dict(blocks=blocks, shard_chains=True, shard_blocks=True),
               dict(blocks=blocks, shard_chains=True,
                    vec_p_init=[0.1, 0.2, 0.3])):   # 3 chains, 8 devices
        with pytest.raises(AssertionError):
            jl.snp_ldpred2_auto(pipe["jc"], pipe["df"], h2_init=0.3,
                                burn_in=2, num_iter=2, **kw)
    grid = {"p": [0.1], "h2": [0.3], "sparse": [False]}
    beta = pt.snp_ldpred2_grid(pipe["pc"], pipe["df"], grid, burn_in=5,
                               num_iter=5)
    samples = pt.snp_ldpred2_grid(pipe["pc"], pipe["df"], grid, burn_in=5,
                                  num_iter=7, blocks=pipe["blocks"],
                                  return_sampling_betas=True)
    assert beta.shape == (pipe["m"], 1) and samples.shape == (pipe["m"], 7)


SHARD_KW = dict(h2_init=0.3, vec_p_init=[0.02, 0.1, 0.3, 0.6], burn_in=20,
                num_iter=20, report_step=10)


def test_shard_chains_equals_unsharded(pipe):
    """shard_chains over 2 CPU shards: each chain equals its unsharded
    run, every output bit for bit (per-chain generators; the MLE's sums
    are row sums, whose order does not change with the chain count)."""
    kw = dict(SHARD_KW, blocks=pipe["blocks"], sparse=True)
    ref = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], **kw)
    got = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], shard_chains=True,
                              mesh=["cpu", "cpu"], **kw)
    assert len(got) == 4
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("use_mle", [True, False])
def test_shard_blocks_matches_unsharded(pipe, use_mle):
    """shard_blocks over 2 and 3 CPU shards within the JAX package's own
    bound for its sharded blocks (rtol 5e-4, tests/test_blocked.py); the
    per-chain sums are reduced in global order, so the port's results
    are in fact the unsharded ones, bit for bit."""
    kw = dict(SHARD_KW, blocks=pipe["blocks"], use_MLE=use_mle)
    ref = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], **kw)
    for shards in (2, 3):
        got = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], shard_blocks=True,
                                  mesh=["cpu"] * shards, **kw)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g["beta_est"], r["beta_est"],
                                       rtol=5e-4, atol=1e-8)
            np.testing.assert_allclose(g["path_h2_est"], r["path_h2_est"],
                                       rtol=5e-4, atol=1e-7)
            for k in r:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_split_blocks_balances_whole_blocks(pipe):
    bb = pt.build_block_bands(pipe["pc"], pipe["blocks"])
    parts = pgb.split_blocks(bb, 3)
    rows = [int(sum((g >= 0).sum() for _, g in b)) for b, _, _ in parts]
    var = np.concatenate([v for _, v, _ in parts])
    np.testing.assert_array_equal(np.sort(var), np.arange(pipe["m"]))
    blk = np.concatenate([k for _, _, k in parts])
    np.testing.assert_array_equal(np.sort(blk), np.arange(len(blk)))
    assert max(rows) - min(rows) <= max(np.asarray(pipe["blocks"]))
    for buckets, v, _ in parts:   # slots renumbered over the shard's own
        for bands, loc in buckets:
            assert loc.max() < len(v) and (loc >= -1).all()
    with pytest.raises(ValueError, match="at least one block"):
        pgb.split_blocks(bb, len(blk) + 1)


def test_shard_blocks_matches_jax(pipe):
    """The port's shard_blocks against the JAX package's shard_blocks=True
    (its GSPMD run on the 8-device CPU mesh) at Monte-Carlo level: the
    streams differ (threefry cannot be replayed, ROADMAP "RNG"), so the
    bounds of test_auto_matches_jax."""
    kw = dict(h2_init=0.3, vec_p_init=[0.1, 0.5], burn_in=100, num_iter=100,
              blocks=pipe["blocks"], use_MLE=False)
    got = pt.snp_ldpred2_auto(pipe["pc"], pipe["df"], shard_blocks=True,
                              mesh=["cpu", "cpu"], **kw)
    ref = jl.snp_ldpred2_auto(pipe["jc"], pipe["df"], shard_blocks=True,
                              **kw)
    for r, j in zip(got, ref):
        assert np.isfinite(r["beta_est"]).all()
        assert np.corrcoef(r["beta_est"], j["beta_est"])[0, 1] > 0.9
        assert r_pred(pipe, r["beta_est"]) > 0.5
        assert abs(r["h2_est"] - j["h2_est"]) < 0.35 * max(j["h2_est"], 0.1)


def test_chain_streams_do_not_depend_on_other_chains(pipe):
    """Per-chain generators: a chain run alone draws what it draws among
    others, so it gives the same result up to the round-off of batched
    reductions over other shapes (the sweep is chain-independent). The
    MLE's grid argmin can flip on such round-off, so it is off here."""
    bb = pt.build_block_bands(pipe["pc"], pipe["blocks"])
    sb = bb.device_put("cpu")
    from bigsnpr_tpu_torch.pgs.ldpred2 import _df_beta_arrays

    bh, N, scale = _df_beta_arrays(pipe["df"])
    lv = 2 * np.log(1 / scale)
    kw = dict(shrink_corr=0.95, p_bounds=(1e-5, 1.0),
              alpha_bounds=np.array([-0.5, 1.5]), mean_ld=3.0, burn_in=8,
              num_iter=8, report_step=4, use_mle=False)
    multi = pgb.gibbs_auto_blocked_multi(
        sb, bh, N, lv, [0.05, 0.2, 0.5], 0.3,
        pgibbs.chain_generators(5, 3, "cpu"), **kw)
    one = pgb.gibbs_auto_blocked(
        sb, bh, N, lv, 0.5, 0.3, pgibbs.chain_generators(5, 3, "cpu")[2],
        **kw)
    for k in one:
        np.testing.assert_allclose(one[k].numpy(), multi[k][2].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    gm = pgb.gibbs_multi_blocked(sb, bh, N, [0.3, 0.2], [0.1, 0.3],
                                 [False, True],
                                 pgibbs.chain_generators(6, 2, "cpu"), 5, 5)
    g1 = pgb.gibbs_one_blocked(sb, bh, N, 0.2, 0.3, True,
                               pgibbs.chain_generators(6, 2, "cpu")[1], 5, 5)
    np.testing.assert_allclose(g1.numpy(), gm[1].numpy(), rtol=1e-4,
                               atol=1e-7)


def test_hyper_draws_match_jax():
    """Given the same normals and uniforms, the Gamma / Beta / Poisson(1)
    draws are the JAX package's functions (float32 round-off)."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(5, 2)).astype(np.float32)
    u1 = rng.uniform(size=(5, 8)).astype(np.float32)
    u2 = rng.uniform(size=(5, 8)).astype(np.float32)
    a = np.array([1.5, 3.0, 30.0, 300.0, 0.8], np.float32)
    b = np.array([100.0, 2.0, 900.0, 5.0, 1.2], np.float32)
    T = torch.as_tensor
    got = pgibbs._beta_draw(T(z), T(u1), T(u2), T(a), T(b)).numpy()
    for c in range(5):
        g1 = jgibbs._gamma_wh(jnp.float32(z[c, 0]), jnp.asarray(u1[c]),
                              jnp.float32(a[c]))
        g2 = jgibbs._gamma_wh(jnp.float32(z[c, 1]), jnp.asarray(u2[c]),
                              jnp.float32(b[c]))
        np.testing.assert_allclose(got[c], float(g1 / (g1 + g2)), rtol=2e-5)
    u = rng.uniform(size=(3, 1000)).astype(np.float32)
    pmf = np.exp(-1) / np.cumprod(np.r_[1.0, np.arange(1.0, 17.0)])
    cdf = np.cumsum(pmf).astype(np.float32)
    got = pgibbs._poisson1(T(u), pgibbs.poisson1_cdf(torch.float32, "cpu"))
    np.testing.assert_array_equal(got.numpy(), (u[..., None] > cdf).sum(-1))


def test_mle_profile_matches_jax_and_lbfgsb():
    from scipy.optimize import minimize

    rng = np.random.default_rng(3)
    m = 500
    log_var = rng.normal(-8, 1.5, m)
    beta = rng.normal(0, np.exp(0.3 * log_var))
    wts = (rng.random((2, m)) < 0.7).astype(float)
    par0 = np.array([np.mean(beta**2), 2 * np.mean(beta**2)])
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    a_got, s_got = pgibbs._mle_alpha_profile(
        T(par0), T(wts), T(log_var), T(np.tile(beta**2, (2, 1))),
        (-0.5, 1.5))
    for c in range(2):
        a_j, s_j = jgibbs._mle_alpha_profile(
            jnp.float32(0), jnp.float32(par0[c]), jnp.asarray(wts[c],
                                                             jnp.float32),
            jnp.asarray(log_var, jnp.float32),
            jnp.asarray(beta**2, jnp.float32),
            (jnp.float32(-0.5), jnp.float32(1.5)))
        assert abs(float(a_got[c]) - float(a_j)) < 1e-3
        np.testing.assert_allclose(float(s_got[c]), float(s_j), rtol=1e-3)
        w = wts[c]

        def obj(par):
            a, s = par
            cc = w * beta**2 * np.exp(-a * log_var)
            return a * (w * log_var).sum() + w.sum() * np.log(s) + cc.sum() / s

        ref = minimize(obj, [0.0, par0[c]], method="L-BFGS-B",
                       bounds=[(-0.5, 1.5), (par0[c] / 2, par0[c] * 2)])
        assert abs(float(a_got[c]) - ref.x[0]) < 1e-2


def test_ind_corr_masking_equals_physical_subset(pipe):
    """ind_corr masking == physical subsetting (reference
    test-8-LDpred2.R:228-308): same bands, same per-chain streams."""
    ind = np.arange(0, pipe["m"], 2)
    df_sub = {k: np.asarray(v)[ind] for k, v in pipe["df"].items()}
    grid = {"p": [0.3], "h2": [0.4], "sparse": [False]}
    masked = pt.snp_ldpred2_grid(pipe["pc"], df_sub, grid, burn_in=20,
                                 num_iter=20, ind_corr=ind, blocks="auto")
    phys = pt.snp_ldpred2_grid(pipe["pc"].subset(ind), df_sub, grid,
                               burn_in=20, num_iter=20, blocks="auto")
    np.testing.assert_allclose(masked, phys, rtol=2e-4, atol=1e-8)
    auto = pt.snp_ldpred2_auto(pipe["pc"], df_sub, h2_init=0.3,
                               vec_p_init=[0.1], burn_in=20, num_iter=20,
                               ind_corr=ind, blocks="auto")[0]
    assert np.isfinite(auto["beta_est"]).all()
    assert len(auto["beta_est"]) == len(ind)
