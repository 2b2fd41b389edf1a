"""Port parity: autoSVD and its robust statistics.

The robust statistics are host numpy copies: within 1e-12 of the JAX
package's. `snp_autoSVD` runs on a small structured cohort (3 populations,
LD between neighbours, one planted long-range-LD region loaded by an
"inversion" carrier status) whose outlier statistics sit far from the
Tukey threshold, in both operator schemes ("highest": K1/K2's twins;
"int8": K6's), against the JAX package's `snp_autoSVD`: the same subset
and `lrldr`, singular values within 1e-4 relative, |cos| >= 0.999 for
each left vector."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.pca import autosvd as jauto
from bigsnpr_tpu.pca import robust as jrob
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.pca import autosvd as pauto
from bigsnpr_tpu_torch.pca import robust as prob

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def lrld_cohort(seed=3, n=400, m=1500):
    """(packed, n, chromosomes, positions, region) with 3 populations, LD
    between neighbours, 1% NA and carriers of an 'inversion' whose 200
    variants (chromosome 2) shift towards dosage 2."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, n)
    p = np.clip(rng.uniform(0.1, 0.5, m)[:, None]
                + rng.normal(0, 0.08, (m, 3)), 0.02, 0.98)
    X = rng.binomial(2, p[:, pop]).astype(float)
    for j in range(1, m):
        if rng.random() < 0.5:
            mask = rng.random(n) < 0.7
            X[j, mask] = X[j - 1, mask]
    carrier = rng.random(n) < 0.3
    reg = slice(600, 800)
    X[reg, carrier] = np.where(rng.random((200, carrier.sum())) < 0.85, 2.0,
                               X[reg, carrier])
    X[rng.random((m, n)) < 0.01] = np.nan
    packed = junpack.np_pack_codes(junpack.np_dosage_to_codes(X))
    chrs = np.repeat([1, 2, 3], m // 3)
    pos = np.tile(np.arange(1, m // 3 + 1) * 1000, 3)
    return packed, n, chrs, pos, (600, 800)


def test_robust_statistics_equal_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((700, 4)) @ rng.standard_normal((4, 4))
    X[:15] += 6.0
    x = np.exp(rng.standard_normal(3001))
    for a, b in ((prob.dist_ogk(X), jrob.dist_ogk(X)),
                 (prob.covrob_ogk(X)[1], jrob.covrob_ogk(X)[1]),
                 (prob.tau_scale_location(x), jrob.tau_scale_location(x)),
                 (prob.rollmean(x, 7), jrob.rollmean(x, 7)),
                 (prob.medcouple(x), jrob.medcouple(x)),
                 (prob.medcouple(np.round(x, 1)),
                  jrob.medcouple(np.round(x, 1))),         # ties at median
                 (prob.tukey_mc_up(x), jrob.tukey_mc_up(x))):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    ints = np.array([1, 2, 3, 7, 9, 10, 11, 12, 20])
    for k in (2, 4):
        np.testing.assert_array_equal(pauto.get_intervals(ints, k),
                                      jauto.get_intervals(ints, k))


@pytest.mark.parametrize("mxu", ["highest", "int8"])
def test_autosvd_matches_jax(mxu):
    packed, n, chrs, pos, (r0, r1) = lrld_cohort()
    kw = dict(infos_chr=chrs, infos_pos=pos, k=4, roll_size=10,
              int_min_size=10)
    js = bt.snp_autoSVD(JaxGenoPack(packed=packed, n=n), **kw)
    with pt.config.options(pallas_mxu=mxu):
        ps = pt.snp_autoSVD(interop.pack_from_numpy(packed, n), **kw)
    np.testing.assert_array_equal(ps.subset, js.subset)
    assert set(ps.lrldr) == set(js.lrldr.columns)
    for col in ps.lrldr:
        np.testing.assert_array_equal(ps.lrldr[col], js.lrldr[col].to_numpy())
    # the planted region is found and dropped
    assert len(ps.lrldr["Chr"]) >= 1 and 2 in ps.lrldr["Chr"]
    assert not np.isin(np.arange(r0 + 20, r1 - 20), ps.subset).any()
    np.testing.assert_allclose(ps.d, js.d, rtol=1e-4)
    cos = np.abs(np.sum(ps.u * js.u, axis=0))
    assert cos.min() >= 0.999, cos
    assert set(ps.stage_times) == {"maf", "clumping", "svd", "outliers"}


def test_autosvd_row_subset_and_no_clumping():
    packed, n, chrs, pos, _ = lrld_cohort(seed=5, n=300, m=900)
    rows = np.arange(0, n, 2)
    kw = dict(infos_chr=chrs, infos_pos=pos, ind_row=rows, k=3,
              thr_r2=np.nan, roll_size=10, int_min_size=10, max_iter=2)
    js = bt.snp_autoSVD(JaxGenoPack(packed=packed, n=n), **kw)
    ps = pt.snp_autoSVD(interop.pack_from_numpy(packed, n), **kw)
    np.testing.assert_array_equal(ps.subset, js.subset)
    assert ps.u.shape == (len(rows), 3)
    np.testing.assert_allclose(ps.d, js.d, rtol=1e-4)
    with pytest.raises(ValueError, match="min_mac"):
        pt.snp_autoSVD(interop.pack_from_numpy(packed, n), min_mac=0)
