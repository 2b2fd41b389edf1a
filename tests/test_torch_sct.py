"""Port parity: Stacked C+T (grid clumping, grid PRS, stacking).

On a 3-chromosome cohort with LD and NA, the port against the JAX package
on the same inputs: the grid clumping's keep sets equal set for set (the
r^2 of the exact pair sums in float64 and the greedy are exact), the grid
PRS within 1e-5 of max |score| (float32 products, K2's twin here, XLA
there), and the stacking on the SAME score matrix within 1e-12 relative
(the same native CD on the same rows). GridPRS persists and reloads,
string chromosome labels included."""

import numpy as np
import pytest
import torch

from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.pgs import sct as jsct
from bigsnpr_tpu.assoc.gwas import big_univLinReg as j_linreg
from bigsnpr_tpu.assoc.gwas import gwas_pvalues as j_pvalues
from bigsnpr_tpu.assoc.simu import snp_simuPheno as j_simu
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop

from oracle_native import private_native


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX oracle's native library, built for this test process alone
    (tests/oracle_native.py), so that no oracle falls back to numpy."""
    yield from private_native(tmp_path_factory)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


@pytest.fixture(scope="module")
def cohort():
    """tests/test_sct.py's copying-haplotype LD on 3 chromosomes of 200
    variants, 1% NA; a GWAS of a simulated phenotype on the training rows."""
    rng = np.random.default_rng(5)
    n, m = 700, 600
    p = rng.uniform(0.1, 0.5, m)
    hap = np.empty((2 * n, m), dtype=np.int8)
    hap[:, 0] = rng.random(2 * n) < p[0]
    for j in range(1, m):
        copy = (rng.random(2 * n) < 0.7) & (j % 200 != 0)
        hap[:, j] = np.where(copy, hap[:, j - 1], rng.random(2 * n) < p[j])
    X = (hap[:n] + hap[n:]).astype(float)
    X[rng.random(X.shape) < 0.01] = np.nan
    packed = junpack.np_pack_codes(junpack.np_dosage_to_codes(X.T))
    jp = JaxGenoPack(packed=packed, n=n)
    y = j_simu(jp, h2=0.5, M=30, seed=3)["pheno"]
    train = np.sort(rng.choice(n, 500, replace=False))
    gwas = j_linreg(jp, y[train], ind_row=train)
    lpS = -j_pvalues(gwas, log10=True)
    chrs = np.repeat([1, 2, 3], 200)
    pos = np.tile(np.arange(1, 201) * 1500.0, 3)
    return dict(jp=jp, pp=interop.pack_from_numpy(packed, n), y=y,
                train=train, betas=gwas["estim"].to_numpy(), lpS=lpS,
                chrs=chrs, pos=pos)


def same_keep(pk, jk):
    assert sorted(pk) == sorted(jk)
    for c in jk:
        assert len(pk[c]) == len(jk[c])
        for a, b in zip(pk[c], jk[c]):
            np.testing.assert_array_equal(a, b)


def test_grid_clumping_keep_sets_equal_jax(cohort):
    c = cohort
    args = (c["chrs"], c["pos"], c["lpS"])
    jk, jg = jsct.snp_grid_clumping(c["jp"], *args, ind_row=c["train"])
    pk, pg = pt.snp_grid_clumping(c["pp"], *args, ind_row=c["train"])
    same_keep(pk, jk)
    for col in pg:
        np.testing.assert_array_equal(pg[col], jg[col].to_numpy())
    assert len(pg["size"]) == 28 and len(pk[1]) == 28
    sizes = [len(k) for k in pk[2]]
    assert min(sizes) < max(sizes)          # the grid changes the sets


def test_grid_clumping_groups_imp_exclude_equal_jax(cohort):
    """The INFO-score and group dimensions of the grid, with excluded
    variants: the same keep sets, the same row order."""
    c = cohort
    rng = np.random.default_rng(9)
    kw = dict(grid_thr_r2=(0.05, 0.5), grid_base_size=(50, 200),
              infos_imp=rng.uniform(0.2, 1.0, 600), grid_thr_imp=(0.3, 0.9),
              groups=[np.arange(0, 600, 2), np.arange(600)],
              exclude=np.arange(100, 130))
    args = (c["chrs"], c["pos"], c["lpS"])
    jk, jg = jsct.snp_grid_clumping(c["jp"], *args, **kw)
    pk, pg = pt.snp_grid_clumping(c["pp"], *args, **kw)
    same_keep(pk, jk)
    assert len(pg["size"]) == 16
    np.testing.assert_array_equal(pg["grp.num"], jg["grp.num"].to_numpy())
    np.testing.assert_array_equal(pg["thr.imp"], jg["thr.imp"].to_numpy())


def test_grid_prs_matches_jax_and_stacking_on_same_scores(cohort, tmp_path):
    c = cohort
    args = (c["chrs"], c["pos"], c["lpS"])
    kw = dict(grid_thr_r2=(0.05, 0.2, 0.8), grid_base_size=(50, 200))
    jk, _ = jsct.snp_grid_clumping(c["jp"], *args, **kw)
    pk, _ = pt.snp_grid_clumping(c["pp"], *args, **kw)
    jm = jsct.snp_grid_PRS(c["jp"], jk, c["betas"], c["lpS"], n_thr_lpS=10,
                           ind_row=c["train"])
    pm = pt.snp_grid_PRS(c["pp"], pk, c["betas"], c["lpS"], n_thr_lpS=10,
                         ind_row=c["train"])
    assert pm.scores.shape == jm.scores.shape == (500, 18 * 10)
    np.testing.assert_array_equal(pm.grid_lpS_thr, jm.grid_lpS_thr)
    err = np.abs(pm.scores - jm.scores).max()
    assert err <= 1e-5 * np.abs(jm.scores).max(), err
    # stacking on the JAX package's score matrix, carried across
    multi = interop.grid_prs_from_numpy(jm.scores, jm.lpS, jm.grid_lpS_thr,
                                        jm.betas, jm.all_keep)
    y = c["y"][c["train"]]
    kw = dict(alphas=(1.0, 0.01), K=5, nlambda=50)
    jres = jsct.snp_grid_stacking(jm, y, **kw)
    pres = pt.snp_grid_stacking(multi, y, **kw)
    np.testing.assert_allclose(pres["beta.G"], jres["beta.G"], rtol=1e-12,
                               atol=1e-12 * np.abs(jres["beta.G"]).max())
    np.testing.assert_allclose(pres["intercept"], jres["intercept"],
                               rtol=1e-12)
    assert pres["mod"].alpha == jres["mod"].alpha
    # the unrolled effects reproduce the stacked model on the scores
    pred = pt.snp_prodVec(c["pp"].subset(ind_row=c["train"]),
                          pres["beta.G"]) + pres["intercept"]
    pred_scores = multi.scores @ pres["mod"].beta + pres["mod"].intercept
    assert np.corrcoef(pred, pred_scores)[0, 1] > 1 - 1e-6
    assert np.corrcoef(pred, y)[0, 1] > 0.3


def test_grid_prs_save_load_round_trip(cohort, tmp_path):
    """In memory and backed by a file; string chromosome labels survive."""
    c = cohort
    chrs = np.where(c["chrs"] == 3, "X", c["chrs"].astype(str))
    keep, _ = pt.snp_grid_clumping(c["pp"], chrs, c["pos"], c["lpS"],
                                   grid_thr_r2=(0.2,), grid_base_size=(100,))
    assert sorted(keep, key=str) == [1, 2, "X"]
    for backing in (None, tmp_path / "scores"):
        m = pt.snp_grid_PRS(c["pp"], keep, c["betas"], c["lpS"], n_thr_lpS=4,
                            backingfile=backing)
        path = m.save(tmp_path / f"grid{backing is None}")
        back = pt.GridPRS.load(path)
        np.testing.assert_array_equal(np.asarray(back.scores), m.scores)
        np.testing.assert_array_equal(back.grid_lpS_thr, m.grid_lpS_thr)
        assert list(back.all_keep) == list(m.all_keep)
        for k in m.all_keep:
            for a, b in zip(back.all_keep[k], m.all_keep[k]):
                np.testing.assert_array_equal(a, b)
        assert (back.backingfile is None) == (backing is None)
    with pytest.raises(FileExistsError):
        pt.snp_grid_PRS(c["pp"], keep, c["betas"], c["lpS"], n_thr_lpS=4,
                        backingfile=tmp_path / "scores")
