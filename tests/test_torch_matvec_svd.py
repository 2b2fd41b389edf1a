"""Port parity: snp_prodVec / snp_cprodVec, TorchOperator and snp_randomSVD
(bigsnpr_tpu_torch.ops.matvec / .linalg.randomsvd against the JAX package
and a dense numpy SVD).

Products are float32 on both sides with other summation orders: rtol and
atol 2e-4. Singular values are held within 1e-4 relative (the solvers'
own tolerance is set far below that), and singular vectors through their
subspaces, on data whose leading PCs are well separated."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.ops.matvec import XlaOperator
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.core import unpack

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def to_port(jpack):
    return interop.pack_from_numpy(np.asarray(jpack.packed), jpack.n)


def structured_packs(n=240, m=400, seed=0):
    """Three populations with distinct allele frequencies: the first two
    PCs stand far above the rest. Returns (JAX pack, port pack)."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, n)
    p = np.clip(rng.uniform(0.1, 0.5, m)[:, None]
                + rng.normal(0, 0.12, (m, 3)), 0.02, 0.98)
    X = rng.binomial(2, p[:, pop]).astype(float)          # (m, n)
    X[rng.random((m, n)) < 0.02] = np.nan
    packed = unpack.np_pack_codes(unpack.np_dosage_to_codes(X))
    return JaxGenoPack(packed=packed, n=n), interop.pack_from_numpy(packed, n)


@pytest.mark.parametrize("shape", ["vec", "mat"])
def test_prodvec_cprodvec_match_jax(shape):
    jp = bt.snp_fake(131, 77, seed=4, na_prob=0.05)
    pp = to_port(jp)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(77 if shape == "vec" else (77, 3))
    v = rng.standard_normal(131 if shape == "vec" else (131, 4))
    np.testing.assert_allclose(pt.snp_prodVec(pp, u),
                               np.asarray(bt.snp_prodVec(jp, u)), **TOL)
    np.testing.assert_allclose(pt.snp_cprodVec(pp, v),
                               np.asarray(bt.snp_cprodVec(jp, v)), **TOL)
    sc = bt.bed_scaleBinom(jp)
    # center and scale are used as given
    np.testing.assert_allclose(
        pt.bed_prodVec(pp, u, sc["center"], sc["scale"]),
        np.asarray(bt.bed_prodVec(jp, u, sc["center"], sc["scale"])), **TOL)
    np.testing.assert_allclose(
        pt.bed_cprodVec(pp, v, sc["center"], sc["scale"]),
        np.asarray(bt.bed_cprodVec(jp, v, sc["center"], sc["scale"])), **TOL)
    with pytest.raises(ValueError):
        pt.snp_prodVec(pp, np.ones(76))


def test_torch_operator_matches_xla_operator():
    jp = bt.snp_fake(150, 90, seed=12, na_prob=0.04)
    pp = to_port(jp)
    sc = bt.bed_scaleBinom(jp)
    jop = XlaOperator(jp, sc["center"], sc["scale"])
    pop = pt.TorchOperator(pp, sc["center"], sc["scale"], block=16)
    rng = np.random.default_rng(2)
    V = rng.standard_normal((150, 6))
    U = rng.standard_normal((90, 2))
    np.testing.assert_allclose(pop.cprod(V), jop.cprod(V), **TOL)
    np.testing.assert_allclose(pop.prod(U), jop.prod(U), **TOL)
    B, Y = pop.power(V)
    Bj, Yj = jop.power(V)
    np.testing.assert_allclose(B, Bj, **TOL)
    np.testing.assert_allclose(Y / np.abs(Yj).max(), Yj / np.abs(Yj).max(),
                               **TOL)


def _subspace_cos(a, b):
    """Cosines of the principal angles between span(a) and span(b)."""
    qa, _ = np.linalg.qr(a)
    qb, _ = np.linalg.qr(b)
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_randomsvd_matches_jax_and_dense(engine):
    jp, pp = structured_packs()
    k = 4
    svd = pt.snp_randomSVD(pp, k=k, tol=1e-7, engine=engine)
    jsvd = bt.snp_randomSVD(jp, k=k, tol=1e-7)
    sc = bt.bed_scaleBinom(jp)
    Xt = np.nan_to_num((jp.to_dosage() - sc["center"]) / sc["scale"])
    u, s, vt = np.linalg.svd(Xt, full_matrices=False)
    np.testing.assert_allclose(svd.d, s[:k], rtol=1e-4)
    np.testing.assert_allclose(svd.d, jsvd.d, rtol=1e-4)
    np.testing.assert_allclose(svd.center, sc["center"], rtol=1e-12)
    # the two population PCs are well separated: vector by vector
    for ref in (u[:, :2], jsvd.u[:, :2]):
        np.testing.assert_allclose(np.abs(np.sum(svd.u[:, :2] * ref, 0)), 1,
                                   atol=1e-4)
    np.testing.assert_allclose(np.abs(np.sum(svd.v[:, :2] * vt[:2].T, 0)), 1,
                               atol=1e-4)
    # the whole top-k subspace
    np.testing.assert_allclose(_subspace_cos(svd.u, u[:, :k]), 1, atol=1e-3)
    np.testing.assert_allclose(_subspace_cos(svd.v, jsvd.v), 1, atol=1e-3)
    # sign convention: the largest-|loading| entry of each u is positive
    top = svd.u[np.argmax(np.abs(svd.u), axis=0), np.arange(k)]
    assert np.all(top > 0)
    np.testing.assert_allclose(svd.scores(), svd.u * svd.d)


def test_randomsvd_masked_subset_parity():
    """As tests/test_pallas.py::test_randomsvd_masked_subset_parity."""
    jp = bt.snp_fake(180, 120, seed=23, na_prob=0.03)
    pp = to_port(jp)
    rng = np.random.default_rng(9)
    ind_row = np.sort(rng.choice(180, size=120, replace=False))
    ind_col = np.sort(rng.choice(120, size=80, replace=False))
    svd = pt.snp_randomSVD(pp, k=5, tol=1e-7, ind_row=ind_row, ind_col=ind_col)
    jsvd = bt.bed_randomSVD(jp, k=5, tol=1e-7, ind_row=ind_row, ind_col=ind_col)
    sub = jp.subset(ind_row=ind_row, ind_col=ind_col)
    sc = bt.bed_scaleBinom(sub)
    Xt = np.nan_to_num((sub.to_dosage() - sc["center"])
                       / np.where(sc["scale"] > 0, sc["scale"], 1.0))
    u, s, _ = np.linalg.svd(Xt, full_matrices=False)
    np.testing.assert_allclose(svd.d, s[:5], rtol=1e-4)
    np.testing.assert_allclose(svd.d, jsvd.d, rtol=1e-4)
    np.testing.assert_allclose(svd.scale, sc["scale"], rtol=1e-12)
    np.testing.assert_allclose(_subspace_cos(svd.u, u[:, :5]), 1, atol=1e-3)


def test_randomsvd_reuses_cached_operator():
    pp = pt.snp_fake(90, 60, seed=3)
    a = pt.snp_randomSVD(pp, k=3, tol=1e-7)
    assert len(pp._op_cache) == 1
    b = pt.bed_randomSVD(pp, k=3, tol=1e-7)
    assert len(pp._op_cache) == 1
    np.testing.assert_array_equal(a.d, b.d)
    # the JAX package's "pallas" / "device" share the kernels' operator
    for engine in ("pallas", "device"):
        np.testing.assert_array_equal(
            pt.snp_randomSVD(pp, k=3, tol=1e-7, engine=engine).d, a.d)
    assert len(pp._op_cache) == 1
    with pytest.raises(ValueError):
        pt.snp_randomSVD(pp, k=3, engine="nope")
