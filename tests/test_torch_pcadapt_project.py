"""Port parity: pcadapt and PCA projection. The JAX package's XLA scans
are torch ops in the port (float32 products, other summation orders):
held within 1e-4 relative (atol 1e-4 of the largest value) on the same
numpy inputs; the host OADP correction is a copy (1e-10)."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.assoc import pcadapt as jpca
from bigsnpr_tpu.pca import project as jproj
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.assoc import pcadapt as ppca
from bigsnpr_tpu_torch.pca import project as pproj

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def close(a, b, tol=1e-4):
    np.testing.assert_allclose(a, b, rtol=tol,
                               atol=tol * np.nanmax(np.abs(b)))


def packs(n=331, m=260, seed=4, na_prob=0.04):
    jp = bt.snp_fake(n, m, seed=seed, na_prob=na_prob)
    return jp, interop.pack_from_numpy(np.asarray(jp.packed), n)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("rows", [None, "even"])
def test_mult_lin_reg_and_pcadapt_match_jax(K, rows):
    jp, pp = packs()
    ind_row = None if rows is None else np.arange(0, jp.n, 2)
    n = jp.n if ind_row is None else len(ind_row)
    U = np.random.default_rng(K).standard_normal((n, K))
    t_j = jpca.mult_lin_reg(jp, U, ind_row=ind_row, block=64)
    t_p = ppca.mult_lin_reg(pp, U, ind_row=ind_row, block=64)
    np.testing.assert_array_equal(np.isnan(t_p), np.isnan(t_j))
    close(np.nan_to_num(t_p), np.nan_to_num(t_j))
    cols = np.arange(5, jp.m, 2)
    j = bt.snp_pcadapt(jp, U, ind_row=ind_row, ind_col=cols)
    p = pt.snp_pcadapt(pp, U, ind_row=ind_row, ind_col=cols)
    close(p.score, j.score)
    close(p.transfo(p.score), j.transfo(j.score))
    close(p.lpval(), j.lpval())
    close(p.pval(), j.pval())


def test_prod_and_row_sums_sq_match_jax():
    jp, pp = packs(n=203, m=300, seed=9)
    sc = bt.bed_scaleBinom(jp)
    cols = np.sort(np.random.default_rng(1).choice(300, 170, replace=False))
    V = np.random.default_rng(2).standard_normal((170, 5))
    xv_j, xn_j = jproj.prod_and_row_sums_sq(jp, V, sc["center"][cols],
                                            sc["scale"][cols], ind_col=cols,
                                            block=32)
    xv_p, xn_p = pproj.prod_and_row_sums_sq(pp, V, sc["center"][cols],
                                            sc["scale"][cols], ind_col=cols,
                                            block=32)
    close(xv_p, xv_j)
    close(xn_p, xn_j)


def test_oadp_is_the_host_copy():
    rng = np.random.default_rng(3)
    XV = rng.standard_normal((40, 6))
    X_norm = (XV ** 2).sum(1) + rng.uniform(1, 50, 40)
    d = np.sort(rng.uniform(5, 30, 6))[::-1]
    np.testing.assert_allclose(pt.pca_OADP_proj(XV, X_norm, d),
                               jproj.pca_OADP_proj(XV, X_norm, d),
                               rtol=1e-10, atol=1e-10)


def test_project_self_pca_matches_jax():
    """bed_projectSelfPCA of the held-out rows on a JAX autoSVD result
    handed across as numpy (the same subset, factors and scaling)."""
    jp, pp = packs(n=420, m=400, seed=12)
    held = np.arange(2, 420, 4)
    train = np.setdiff1d(np.arange(420), held)
    jsvd = bt.snp_autoSVD(jp, ind_row=train, k=3, thr_r2=0.5, max_iter=1,
                          roll_size=5)
    psvd = interop.svd_from_numpy(jsvd.d, jsvd.u, jsvd.v, jsvd.center,
                                  jsvd.scale, jsvd.niter, subset=jsvd.subset)
    j = jproj.bed_projectSelfPCA(jsvd, jp, ind_row=held)
    p = pt.bed_projectSelfPCA(psvd, pp, ind_row=held)
    for key in ("simple_proj", "OADP_proj"):
        close(p[key], j[key])
    assert p["obj.svd.ref"] is psvd
    # bed_projectPCA (ported since slice 6) matches the packs' maps
    with pytest.raises(ValueError, match="need a map"):
        pt.bed_projectPCA(pp, pp)


def cross_dataset_packs():
    """tests/test_impute_project.py::test_project_pca_cross_dataset's
    packs: a reference of 200 samples, and the other 100 as a target,
    as they are and with every fifth variant's alleles reversed (map and
    genotypes)."""
    from bigsnpr_tpu.core import unpack as up
    from bigsnpr_tpu.core.genotypes import GenoPack

    pack = bt.snp_fake(300, 260, seed=44)
    ref = pack.subset(ind_row=np.arange(0, 200))
    new = pack.subset(ind_row=np.arange(200, 300))
    X = new.to_dosage()
    rev = np.zeros(260, dtype=bool)
    rev[::5] = True
    Xr = np.where(rev[None, :], 2 - X, X)
    new_map = new.map.copy()
    a1 = new_map["allele1"].to_numpy().copy()
    a2 = new_map["allele2"].to_numpy().copy()
    a1[rev], a2[rev] = a2[rev], a1[rev]
    new_map["allele1"], new_map["allele2"] = a1, a2
    new_rev = GenoPack(packed=up.np_pack_codes(up.np_dosage_to_codes(Xr.T)),
                       n=new.n, fam=new.fam, map=new_map)
    return ref, new, new_rev


@pytest.mark.parametrize("reversed_", [False, True])
def test_project_pca_matches_jax(reversed_):
    """bed_projectPCA of the port against the JAX package's on the same
    packs: the autoSVD subsets equal, the simple and OADP projections
    within 1e-4; the reversed target's projection within 1e-3 of the
    unreversed one (the JAX test's bound)."""
    ref, new, new_rev = cross_dataset_packs()
    target = new_rev if reversed_ else new
    kw = dict(k=4, thr_r2=0.95, min_mac=2, min_maf=0.01, max_iter=1)
    jres = jproj.bed_projectPCA(ref, target, **kw)
    port = lambda p: interop.pack_from_numpy(  # noqa: E731
        np.asarray(p.packed), p.n, fam=p.fam, map=p.map)
    pres = pproj.bed_projectPCA(port(ref), port(target), **kw)
    assert np.array_equal(pres["obj.svd.ref"].subset,
                          jres["obj.svd.ref"].subset)
    for key in ("simple_proj", "OADP_proj"):
        close(pres[key], np.asarray(jres[key]))
    if reversed_:
        p0 = pproj.bed_projectPCA(port(ref), port(new), **kw)
        np.testing.assert_allclose(pres["simple_proj"], p0["simple_proj"],
                                   rtol=1e-3, atol=1e-3)
