"""The port's first slice end to end: .bed -> scaling -> randomSVD ->
simuPheno -> GWAS (covariates = PCs) -> p-values -> C+T scores, and the
third (autoSVD -> pcadapt -> projection, on the int8 scheme) through both
packages on the same file; the fourth (randomSVD and GWAS on the split2
scheme -> grid clumping -> grid PRS -> stacking; LD -> blocked lassosum2)
and the fifth (randomSVD on an int8m operator -> GWAS -> LD -> the
unblocked lassosum2 and LDpred2) through both packages on the same pack;
all five slices (the second: LD -> LDSC -> blocks -> LDpred2-auto / grid
-> PRS) and imputation -> autoSVD in the port alone with jax, pandas and
the JAX package blocked;
the device rule (no CUDA and no request for the CPU -> an entry point
raises); and chip_smoke.py's CPU rehearsal."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.core import unpack

from oracle_native import private_native


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX oracle's native library, built for this test process alone
    (tests/oracle_native.py), so that no oracle falls back to numpy."""
    yield from private_native(tmp_path_factory)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV2 = {**os.environ, "OMP_NUM_THREADS": "2"}   # subprocesses: 2 threads


def structured_cohort(n, m, seed):
    """Three populations (the first two PCs stand out), 1% NA."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, n)
    p = np.clip(rng.uniform(0.1, 0.5, m)[:, None]
                + rng.normal(0, 0.1, (m, 3)), 0.02, 0.98)
    X = rng.binomial(2, p[:, pop]).astype(float)
    X[rng.random((m, n)) < 0.01] = np.nan
    return unpack.np_pack_codes(unpack.np_dosage_to_codes(X))


def test_chain_matches_jax(tmp_path):
    n, m, k = 601, 2000, 2
    meta = bt.snp_fake(n, m, seed=1)
    jsrc = JaxGenoPack(packed=structured_cohort(n, m, 1), n=n, fam=meta.fam,
                       map=meta.map)
    bed = bt.snp_writeBed(jsrc, tmp_path / "cohort.bed")
    jp, pp = bt.snp_readBed(bed), pt.snp_readBed(bed)
    test = np.arange(0, n, 3)
    train = np.setdiff1d(np.arange(n), test)
    with pt.config.options(device="cpu"):
        # scaling: float64 on equal counts (1e-12)
        jsc, psc = bt.bed_scaleBinom(jp), pt.bed_scaleBinom(pp)
        np.testing.assert_allclose(psc["scale"], jsc["scale"], rtol=1e-12)
        # PCA: d within 1e-4; the two population PCs vector by vector
        jsvd = bt.snp_randomSVD(jp, k=k, tol=1e-7)
        psvd = pt.snp_randomSVD(pp, k=k, tol=1e-7)
        np.testing.assert_allclose(psvd.d, jsvd.d, rtol=1e-4)
        np.testing.assert_allclose(psvd.u, jsvd.u, atol=1e-4)
        # phenotype: same causal set, float32 liabilities (1e-5)
        jsim = bt.snp_simuPheno(jp, h2=0.5, M=100, seed=3)
        psim = pt.snp_simuPheno(pp, h2=0.5, M=100, seed=3)
        np.testing.assert_array_equal(psim["set"], jsim["set"])
        np.testing.assert_allclose(psim["pheno"], jsim["pheno"], atol=1e-5)
        y = psim["pheno"]
        # GWAS on each package's own PCs (rtol 1e-4, atol 1e-4 * max)
        jg = bt.big_univLinReg(jp, y[train], covar=jsvd.u[train],
                               ind_row=train)
        pg = pt.big_univLinReg(pp, y[train], covar=psvd.u[train],
                               ind_row=train)
        for key in ("estim", "std.err"):
            ref = jg[key].to_numpy()
            np.testing.assert_allclose(pg[key], ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max())
        from bigsnpr_tpu.assoc.gwas import gwas_pvalues as j_pvalues

        jl = -j_pvalues(jg, log10=True)
        np.testing.assert_allclose(-pt.gwas_pvalues(pg, log10=True), jl,
                                   rtol=1e-3, atol=1e-3)
        # scores over 10 thresholds on the test samples, from one GWAS
        thr = np.linspace(0, np.quantile(jl, 0.99), 10)
        beta = jg["estim"].to_numpy()
        jprs = bt.snp_PRS(jp, beta, ind_test=test, lpS_keep=jl, thr_list=thr)
        pprs = pt.snp_PRS(pp, beta, ind_test=test, lpS_keep=jl, thr_list=thr)
        np.testing.assert_allclose(pprs, jprs, rtol=1e-4,
                                   atol=1e-4 * np.abs(jprs).max())
        r = max(np.corrcoef(pprs[:, i], y[test])[0, 1] for i in range(10))
        assert r > 0.2, r
        # slice 3 on the training rows, the port under the int8 scheme:
        # autoSVD (same subset, d within 1e-4) -> pcadapt -> projection of
        # the test rows (1e-4 of the largest value)
        kw = dict(ind_row=train, k=k, thr_r2=0.2, roll_size=20,
                  infos_chr=np.repeat([1, 2], m // 2))
        ja = bt.snp_autoSVD(jp, **kw)
        with pt.config.options(pallas_mxu="int8"):
            pa = pt.snp_autoSVD(pp, **kw)
        np.testing.assert_array_equal(pa.subset, ja.subset)
        np.testing.assert_allclose(pa.d, ja.d, rtol=1e-4)
        jpc = bt.snp_pcadapt(jp, ja.u, ind_row=train, ind_col=ja.subset)
        ppc = pt.snp_pcadapt(pp, pa.u, ind_row=train, ind_col=pa.subset)
        np.testing.assert_allclose(ppc.lpval(), jpc.lpval(), rtol=1e-3,
                                   atol=1e-3 * np.abs(jpc.lpval()).max())
        jproj = bt.bed_projectSelfPCA(ja, jp, ind_row=test)["OADP_proj"]
        pproj = pt.bed_projectSelfPCA(pa, pp, ind_row=test)["OADP_proj"]
        np.testing.assert_allclose(np.abs(pproj), np.abs(jproj), rtol=1e-3,
                                   atol=1e-3 * np.abs(jproj).max())


def test_slice4_chain_matches_jax():
    """randomSVD and GWAS under split2 -> grid clumping -> grid PRS ->
    stacking, and snp_cor -> auto blocks -> lassosum2, in both packages.
    The clumping and the stacking take the JAX package's p-values and
    scores where exactness is the point (keep sets equal, stacking 1e-12);
    the port's own scores agree within 1e-5 and predict as well."""
    from bigsnpr_tpu import config as jconfig
    from bigsnpr_tpu.pgs import sct as jsct
    from bigsnpr_tpu.pgs.lassosum2 import snp_lassosum2 as j_lassosum2
    from bigsnpr_tpu_torch import interop

    n, m = 601, 1600
    packed = structured_cohort(n, m, 4)
    jp = JaxGenoPack(packed=packed, n=n)
    pp = interop.pack_from_numpy(packed, n)
    test = np.arange(0, n, 4)
    train = np.setdiff1d(np.arange(n), test)
    chrs = np.repeat([1, 2], m // 2)
    pos = np.tile(np.arange(1, m // 2 + 1) * 2000.0, 2)
    with pt.config.options(device="cpu", pallas_mxu="split2"):
        with jconfig.options(pallas_mxu="split2"):
            jsvd = bt.snp_randomSVD(jp, k=3, ind_row=train, tol=1e-7,
                                    engine="pallas")
        psvd = pt.snp_randomSVD(pp, k=3, ind_row=train, tol=1e-7)
        np.testing.assert_allclose(psvd.d, jsvd.d, rtol=1e-4)
        y = bt.snp_simuPheno(jp, h2=0.6, M=60, seed=5)["pheno"]
        jg = bt.big_univLinReg(jp, y[train], covar=jsvd.u, ind_row=train)
        pg = pt.big_univLinReg(pp, y[train], covar=jsvd.u, ind_row=train)
    for key in ("estim", "std.err"):
        ref = jg[key].to_numpy()
        np.testing.assert_allclose(pg[key], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    from bigsnpr_tpu.assoc.gwas import gwas_pvalues as j_pvalues

    lpS = -j_pvalues(jg, log10=True)
    betas = jg["estim"].to_numpy()
    kw = dict(grid_thr_r2=(0.05, 0.2, 0.8), grid_base_size=(50, 200))
    jk, _ = jsct.snp_grid_clumping(jp, chrs, pos, lpS, ind_row=train, **kw)
    with pt.config.options(device="cpu"):
        pk, _ = pt.snp_grid_clumping(pp, chrs, pos, lpS, ind_row=train, **kw)
        for c in jk:
            for a, b in zip(pk[c], jk[c]):
                np.testing.assert_array_equal(a, b)
        jm = jsct.snp_grid_PRS(jp, jk, betas, lpS, n_thr_lpS=6,
                               ind_row=train)
        pm = pt.snp_grid_PRS(pp, pk, betas, lpS, n_thr_lpS=6, ind_row=train)
        assert np.abs(pm.scores - jm.scores).max() <= \
            1e-5 * np.abs(jm.scores).max()
        skw = dict(alphas=(0.01, 0.0001), K=4, nlambda=40)
        jres = jsct.snp_grid_stacking(jm, y[train], **skw)
        same = pt.snp_grid_stacking(interop.grid_prs_from_numpy(
            jm.scores, jm.lpS, jm.grid_lpS_thr, jm.betas, jm.all_keep),
            y[train], **skw)
        np.testing.assert_allclose(same["beta.G"], jres["beta.G"],
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(jres["beta.G"]).max())
        own = pt.snp_grid_stacking(pm, y[train], **skw)
        sub = pp.subset(ind_row=test)
        r_j = np.corrcoef(pt.snp_prodVec(sub, jres["beta.G"]), y[test])[0, 1]
        r_p = np.corrcoef(pt.snp_prodVec(sub, own["beta.G"]), y[test])[0, 1]
        assert r_p > 0.2 and abs(r_p - r_j) < 0.02, (r_p, r_j)
        # LD -> blocks -> lassosum2 (float32, bit-equal sweeps)
        jcorr = bt.snp_cor(jp, ind_row=train, size=20)
        pcorr = pt.snp_cor(pp, ind_row=train, size=20)
        assert (pcorr.upper != jcorr.upper).nnz == 0
        df = {"beta": betas, "beta_se": jg["std.err"].to_numpy(),
              "n_eff": np.full(m, float(len(train)))}
        blocks = pt.auto_blocks(pcorr, max_block=400)
        jb, jgp = j_lassosum2(jcorr, df, nlambda=4, maxiter=100,
                              blocks=blocks)
        pb, pgp = pt.snp_lassosum2(pcorr, df, nlambda=4, maxiter=100,
                                   blocks=blocks)
        np.testing.assert_array_equal(pgp["num_iter"],
                                      jgp["num_iter"].to_numpy())
        ok = np.isfinite(jb)
        np.testing.assert_array_equal(np.isfinite(pb), ok)
        assert np.abs(pb[ok] - jb[ok]).max() <= 1e-6 * np.abs(jb[ok]).max()


def test_slice5_chain_matches_jax():
    """randomSVD on an int8m operator (the JAX package's Pallas operator in
    interpret mode) -> GWAS -> snp_cor -> LDSC -> the unblocked samplers
    (blocks=None) in both packages. The SVD within 1e-4 and bit-equal to
    the port's int8 one; lassosum2 is deterministic (num_iter equal, 1e-6);
    LDpred2-grid and -auto draw from other generators, so their betas agree
    at Monte-Carlo level (r > 0.9) and their scores predict alike."""
    from bigsnpr_tpu.ops import pallas_kernels as jpk
    from bigsnpr_tpu.pgs.lassosum2 import snp_lassosum2 as j_lassosum2
    from bigsnpr_tpu_torch import interop

    n, m = 601, 1200
    packed = structured_cohort(n, m, 6)
    jp = JaxGenoPack(packed=packed, n=n)
    pp = interop.pack_from_numpy(packed, n)
    test = np.arange(0, n, 4)
    train = np.setdiff1d(np.arange(n), test)
    sc = bt.bed_scaleBinom(jp, ind_row=train)
    scd = {"center": sc["center"], "scale": sc["scale"]}
    jop = jpk.PallasOperator(jp, sc["center"], sc["scale"], ind_row=train,
                             interpret=True, mxu="int8m")
    jsvd = bt.snp_randomSVD(None, scd, op=jop, k=3, engine="device",
                            tol=1e-7)
    with pt.config.options(device="cpu"):
        svds = [pt.snp_randomSVD(None, scd, k=3, tol=1e-7, op=pt.GenoOperator(
            pp, sc["center"], sc["scale"], ind_row=train, mxu=mxu))
            for mxu in ("int8m", "int8")]
        psvd = svds[0]
        np.testing.assert_allclose(psvd.d, jsvd.d, rtol=1e-4)
        np.testing.assert_array_equal(psvd.u, svds[1].u)
        y = bt.snp_simuPheno(jp, h2=0.7, M=40, seed=7)["pheno"]
        jg = bt.big_univLinReg(jp, y[train], covar=jsvd.u, ind_row=train)
        pg = pt.big_univLinReg(pp, y[train], covar=jsvd.u, ind_row=train)
        for key in ("estim", "std.err"):
            ref = jg[key].to_numpy()
            np.testing.assert_allclose(pg[key], ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max())
        jcorr = bt.snp_cor(jp, ind_row=train, size=20)
        pcorr = pt.snp_cor(pp, ind_row=train, size=20)
        assert (pcorr.upper != jcorr.upper).nnz == 0
        df = {"beta": jg["estim"].to_numpy(),
              "beta_se": jg["std.err"].to_numpy(),
              "n_eff": np.full(m, float(len(train)))}
        h2 = float(pt.snp_ldsc2(pcorr, df)["h2"])
        jb, jgp = j_lassosum2(jcorr, df, nlambda=4, maxiter=100)
        pb, pgp = pt.snp_lassosum2(pcorr, df, nlambda=4, maxiter=100)
        np.testing.assert_array_equal(pgp["num_iter"],
                                      jgp["num_iter"].to_numpy())
        ok = np.isfinite(jb)
        np.testing.assert_array_equal(np.isfinite(pb), ok)
        assert np.abs(pb[ok] - jb[ok]).max() <= 1e-6 * np.abs(jb[ok]).max()
        grid = {"p": [0.1], "h2": [max(h2, 0.1)], "sparse": [False]}
        kw = dict(burn_in=50, num_iter=200)
        pgrid = pt.snp_ldpred2_grid(pcorr, df, grid, **kw)
        jgrid = bt.snp_ldpred2_grid(jcorr, df, grid, **kw)
        assert np.corrcoef(pgrid[:, 0], jgrid[:, 0])[0, 1] > 0.9
        sub = pp.subset(ind_row=test)
        r = [np.corrcoef(pt.snp_prodVec(sub, b), y[test])[0, 1]
             for b in (pgrid[:, 0], jgrid[:, 0])]
        assert r[0] > 0.2 and abs(r[0] - r[1]) < 0.05, r


# Blocks the imports with a finder that raises, which has the effect of
# sys.modules[name] = None; None entries themselves trip scipy's array-API
# helpers, which look up sys.modules["jax"].Array.
SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "bigsnpr_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import bigsnpr_tpu_torch as pt
    from bigsnpr_tpu_torch import interop  # noqa: F401

    pt.config.set_device("cpu")
    pack = pt.snp_fake(203, 300, seed=1, na_prob=0.02)
    bed = pt.snp_writeBed(pack, sys.argv[2] + "/x.bed")
    pack = pt.snp_readBed(bed)
    sc = pt.bed_scaleBinom(pack)
    svd = pt.snp_randomSVD(pack, k=3)
    sim = pt.snp_simuPheno(pack, h2=0.5, M=10, seed=1)
    g = pt.big_univLinReg(pack, sim["pheno"], covar=svd.u)
    lp = -pt.gwas_pvalues(g, log10=True)
    prs = pt.snp_PRS(pack, g["estim"], lpS_keep=lp, thr_list=[0, 1, 2])
    lr = pt.big_univLogReg(pack, (sim["pheno"] > 0).astype(int))
    assert prs.shape == (203, 3) and np.isfinite(prs).all()
    assert np.isfinite(lr["estim"]).all()
    # slice 2: LD -> LDSC -> blocks -> LDpred2-auto / grid -> PRS
    df = {"beta": g["estim"], "beta_se": g["std.err"],
          "n_eff": np.full(pack.m, 203.0)}
    corr = pt.snp_cor(pack, size=20, finalize="device")
    h2 = pt.snp_ldsc2(corr, df)["h2"]
    assert pt.snp_ldsplit(corr, thr_r2=0.0, min_size=10, max_size=100,
                          max_K=60, max_cost=np.inf) is not None
    blocks = pt.auto_blocks(corr, max_block=100)
    auto = pt.snp_ldpred2_auto(corr, df, h2_init=0.3, vec_p_init=[0.01, 0.1],
                               burn_in=5, num_iter=5, blocks=blocks)
    keep, beta_auto = pt.ldpred2_auto_chain_qc(auto)
    grid = pt.snp_ldpred2_grid(corr, df, {"p": [0.1], "h2": [0.3],
                                          "sparse": [True]},
                               burn_in=3, num_iter=3, blocks=blocks)
    prs2 = pt.snp_PRS(pack, np.nan_to_num(beta_auto))
    assert np.isfinite(h2) and grid.shape == (pack.m, 1)
    assert prs2.shape == (203, 1) and np.isfinite(prs2).all()
    # slice 3 on the int8 scheme: autoSVD -> pcadapt -> projection -> GWAS
    rows = np.arange(0, 203, 4)
    train = np.setdiff1d(np.arange(203), rows)
    chrs = np.repeat([1, 2, 3], 100)
    with pt.config.options(pallas_mxu="int8"):
        asvd = pt.snp_autoSVD(pack, infos_chr=chrs, ind_row=train, k=3,
                              roll_size=10, infos_pos=np.arange(300) * 1000)
        pc = pt.snp_pcadapt(pack, asvd.u, ind_row=train, ind_col=asvd.subset)
        proj = pt.bed_projectSelfPCA(asvd, pack, ind_row=rows)
        g3 = pt.big_univLinReg(pack, sim["pheno"][train], covar=asvd.u,
                               ind_row=train)
    assert set(asvd.lrldr) == {"Chr", "Start", "Stop", "Iter"}
    assert np.isfinite(pc.lpval()).all() and np.isfinite(g3["estim"]).all()
    assert proj["OADP_proj"].shape == (len(rows), 3)
    # slice 4 on the split2 scheme: randomSVD -> GWAS -> SCT; lassosum2
    with pt.config.options(pallas_mxu="split2"):
        s4 = pt.snp_randomSVD(pack, k=3, ind_row=train)
        g4 = pt.big_univLinReg(pack, sim["pheno"][train], covar=s4.u,
                               ind_row=train)
    lp4 = -pt.gwas_pvalues(g4, log10=True)
    keep, grid4 = pt.snp_grid_clumping(pack, chrs, np.arange(300) * 1000,
                                       lp4, ind_row=train,
                                       grid_thr_r2=(0.2,),
                                       grid_base_size=(50, 100))
    multi = pt.snp_grid_PRS(pack, keep, g4["estim"], lp4, n_thr_lpS=3,
                            ind_row=train)
    final = pt.snp_grid_stacking(multi, sim["pheno"][train], K=3, nlambda=20)
    bl, gp = pt.snp_lassosum2(corr, df, nlambda=3, maxiter=30, blocks=blocks)
    assert multi.scores.shape == (len(train), 3 * 2 * 3)
    assert np.isfinite(final["beta.G"]).all() and len(gp["num_iter"]) == 12
    assert bl.shape == (pack.m, 12)
    # slice 5: randomSVD on the int8m operator -> GWAS; the unblocked
    # LDpred2-auto / grid / sampling and lassosum2 (blocks=None)
    sc5 = pt.bed_scaleBinom(pack, ind_row=train)
    op5 = pt.GenoOperator(pack, sc5["center"], sc5["scale"], ind_row=train,
                          mxu="int8m")
    s5 = pt.snp_randomSVD(None, {"center": sc5["center"],
                                 "scale": sc5["scale"]}, op=op5, k=3)
    g5 = pt.big_univLinReg(pack, sim["pheno"][train], covar=s5.u,
                           ind_row=train)
    auto5 = pt.snp_ldpred2_auto(corr, df, 0.3, burn_in=3, num_iter=3,
                                sparse=True)
    one = {"p": [0.1], "h2": [0.3], "sparse": [False]}
    grid5 = pt.snp_ldpred2_grid(corr, df, one, burn_in=3, num_iter=3)
    samp5 = pt.snp_ldpred2_grid(corr, df, one, burn_in=3, num_iter=4,
                                return_sampling_betas=True)
    bl5, gp5 = pt.snp_lassosum2(corr, df, nlambda=3, maxiter=30)
    assert np.isfinite(g5["estim"]).all() and s5.u.shape == (len(train), 3)
    assert "dropped_r2_frac" not in auto5[0] and grid5.shape == (pack.m, 1)
    assert samp5.shape == (pack.m, 4) and bl5.shape == (pack.m, 12)
    # slice 6d: imputation -> autoSVD on the imputed pack
    nas = pt.snp_fake(203, 300, seed=2, na_prob=0.05)
    imp, info = pt.snp_fastImpute(nas, seed=1)
    boo, _ = pt.snp_fastImpute(nas, seed=1, method="boost")
    for meth in ("mode", "mean0", "random", "mean2"):
        pt.snp_fastImputeSimple(nas, meth, seed=1)
    assert not np.isnan(imp.to_dosage()).any() and np.isfinite(info[1]).all()
    assert pt.snp_autoSVD(imp, k=2, roll_size=10).u.shape == (203, 2)
    bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not bad, bad
    print("PORT-ONLY-OK")
""")


def test_port_runs_without_jax_pandas_or_jax_package(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT, REPO, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=ENV2)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PORT-ONLY-OK" in out.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    pack = pt.snp_fake(20, 10, seed=1)
    with pt.config.options(device="cuda"):
        for call in (lambda: pt.snp_counts(pack),
                     lambda: pt.snp_randomSVD(pack, k=2),
                     lambda: pt.snp_prodVec(pack, np.ones(10)),
                     lambda: pt.snp_cor(pack, size=5),
                     lambda: pack.device_packed()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    # a per-call request for the CPU works whatever the default
    assert pt.snp_counts(pack, device="cpu").shape == (4, 10)


def test_chip_smoke_alone_or_without_cuda_prints_no_result(tmp_path):
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(src)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120, env=ENV2)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_rehearses_every_phase_on_cpu():
    """The chip script's phases run through the twins at a small size;
    the rehearsal ends non-zero and prints no result, by design."""
    out = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse-cpu",
                          "--n", "803", "--m", "1200", "--n2", "803",
                          "--m2", "1200", "--bmin", "100", "--bmax", "300",
                          "--burn-in", "4", "--num-iter", "4", "--n3", "1500",
                          "--m3", "4000", "--region", "400", "--n4", "1500",
                          "--m4", "4000", "--n-thr", "2", "--nlambda", "3",
                          "--lasso-maxiter", "20", "--n-stack", "600",
                          "--n5", "803", "--m5", "1200", "--burn-in5", "4",
                          "--num-iter5", "4", "--gdp-rows", "600",
                          "--lasso-points", "8", "--n6", "600",
                          "--n6-ref", "300", "--m6", "3000",
                          "--n-sumstats", "6000", "--n-grm", "200",
                          "--n7", "300", "--m7", "1500", "--n8", "300",
                          "--m8", "1500"],
                         cwd=REPO,
                         capture_output=True, text=True, timeout=300, env=ENV2)
    assert out.returncode == 3, out.stdout[-2000:] + out.stderr[-2000:]
    assert "CPU rehearsal passed" in out.stderr
    assert '"ok"' not in out.stdout
    for phase in ("[2b]", "[3]", "[3b]", "[4]", "[5]", "r(PRS, y)", "[6]",
                  "snp_ldpred2_auto", "r(PRS_auto, y_test)",
                  "without the r2 floor", "[7]", "K3 shape", "K4 shape",
                  "K5 shape", "grid shape", "f64 shape", "[9]",
                  "cprod_i8_nona", "masked int8 operator", "[10]",
                  "snp_autoSVD on K1/K2", "pcadapt, K = 2", "[11]",
                  "torch._int_mm", "NA-free copy, int8", "[12]",
                  "masked split2 operator", "[13]", "snp_grid_stacking",
                  "r(SCT prediction", "native greedy vs the fixed point",
                  "lassosum2: grid point", "[14]", "bf16 torch.matmul",
                  "lassosum mode", "[15]", "cprod_i8m_nona",
                  "masked int8m operator", "sweep, float64, one band",
                  "lassosum, float32, 12 blocks", "[16]",
                  "snp_randomSVD on K8 vs on K6", "snp_ldpred2_auto "
                  "(unblocked)", "sampling betas", "[17a]",
                  "NA-free copy, int8m", "[17b]", "depth past 2^23",
                  "[18]", "store", "snp_match", "bed_projectPCA",
                  "bed_GRM", "[19]", "snp_readBGEN", "per-variant Python "
                  "decode", "read_as='random'", "PCA on the byte path",
                  "snp_cor on the byte path", "snp_prodBGEN over",
                  "r(PRS on hard calls", ".dpk store", "byte path, ",
                  "warmup sections", "[20]", "simple: discordance",
                  "ridge stage on the host clock", "snp_fastImpute: "
                  "discordance", "boost block at", "[20] imputed pack",
                  "snp_autoSVD kept", "[21a]", "randomSVD on the mesh",
                  "colstats over the mesh", "[21b] 2 ranks, gloo",
                  "randomSVD over 2 ranks", "engine \"auto\" builds",
                  "2 ranks x 2 shards, gloo (mesh 2 x 2)",
                  "randomSVD over 2 ranks x 2 shards", "[21c]",
                  "shard_chains: every chain bit-equal", "shard_blocks: ",
                  "[22a]", "moves the GRM off", "[22b]"):
        assert phase in out.stdout
