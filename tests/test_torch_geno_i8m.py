"""Port parity: the "int8m" scheme of the genotype operator (kernel K8,
K6's GEMMs on int8 planes materialized once).

On the CPU the wrappers run their plain twins (`cprod_i8m_plain`,
`prod_i8m_plain`). Held here: the planes bit-equal to the JAX package's
`materialize_int8_planes` once its bit-plane sample order and padding are
undone; the twins' raw digit sums equal to an int64 numpy oracle and to
K6's twin on the same pack (so their outputs are bit-equal too); the
operator against `PallasOperator(interpret=True, mxu="int8m")` within
1e-5 of max |ref| and a float64 dense oracle within 5e-6 (the bounds of
tests/test_torch_geno_i8.py); randomSVD on it against the JAX package's
on the same operator, d within 1e-4 and |cos(u)| >= 0.999.
tests/test_torch_cuda.py holds the CUDA kernel against the twins on a
card."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.ops import pallas_kernels as pk
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import geno_kernels as gk

torch.set_num_threads(2)
JAX_TOL = 1e-5
ORACLE_TOL = 5e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def dense(packed, n, center, scale):
    """float64 oracle (n, m) with the scale-0 rule, NA -> 0."""
    X = junpack.np_unpack_codes(packed, n).astype(int)
    d = np.where(X == 1, np.nan, 2 - ((X + 1) >> 1)).T.astype(float)
    good = scale > 0
    Xt = (d - np.where(good, center, 2.0)) / np.where(good, scale, 1.0)
    Xt[:, ~good] = 0.0
    return np.nan_to_num(Xt, nan=0.0)


def codes_pack(rng, n, m, na_prob):
    codes = rng.choice(np.array([0, 2, 3], np.uint8), size=(m, n))
    codes[rng.random((m, n)) < na_prob] = 1
    codes[::19] = 0                                  # monomorphic
    return junpack.np_pack_codes(codes)


def close(a, b, tol):
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), (
        np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n", [1000, 1001, 1003])
@pytest.mark.parametrize("nona", [False, True])
def test_planes_bit_equal_to_jax(n, nona):
    """int8m_planes == materialize_int8_planes(_chunked) in true sample
    order: the JAX columns permuted back by sample_perm, its pad variants
    and samples dropped; the port's pad columns (n to ldn) are zero."""
    rng = np.random.default_rng(n)
    m = 150
    packed = codes_pack(rng, n, m, 0.0 if nona else 0.05)
    jop = pk.PallasOperator(bt.GenoPack(packed=packed, n=n), np.ones(m),
                            np.ones(m), interpret=True, mxu="int8m",
                            nona=nona)
    T, NA = gk.int8m_planes(torch.as_tensor(packed), n, nona, chunk=64)
    ldn = -(-n // 16) * 16
    assert T.shape == (m, ldn) and (NA is None) == nona
    cols = jop.inv_perm[:n]
    for got, ref in ((T, jop.planes[0]), (NA, jop.planes[1])):
        if got is None:
            assert ref is None
            continue
        np.testing.assert_array_equal(got[:, :n].numpy(),
                                      np.asarray(ref)[:m][:, cols])
        assert not got[:, n:].any()


@pytest.mark.parametrize("n", [1000, 1001, 1002, 1003])
@pytest.mark.parametrize("nona", [False, True])
def test_raw_sums_equal_int64_oracle_and_k6(n, nona):
    rng = np.random.default_rng(n + 7)
    m, l = 150, 6
    packed = codes_pack(rng, n, m, 0.0 if nona else 0.05)
    g = junpack.np_unpack_codes(packed, n).astype(np.int64)
    b0, b1 = g & 1, g >> 1
    planes_np = [b1 + (b0 & b1)] + ([] if nona else [b0 & ~b1 & 1])
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    c, inv = t(rng.uniform(0, 2, m)), t(rng.uniform(0.5, 2, m))
    V, U = t(rng.standard_normal((n, l))), t(rng.standard_normal((m, l)))
    P = torch.as_tensor(packed)
    planes = gk.int8m_planes(P, n, nona)
    out, raw = gk.cprod_i8m(planes, n, V, c, inv, return_raw=True)
    out6, raw6 = gk.cprod_i8(P, n, V, c, inv, nona=nona, return_raw=True)
    q8 = gk._cprod_i8_operands(V, c, inv)[0].numpy().astype(np.int64)
    for p, X in enumerate(planes_np):
        np.testing.assert_array_equal(raw[p].numpy(), X @ q8.T)
    assert torch.equal(raw, raw6) and torch.equal(out, out6)
    out, raw = gk.prod_i8m(planes, n, U, c, inv, return_raw=True)
    out6, raw6 = gk.prod_i8(P, n, U, c, inv, nona=nona, return_raw=True)
    ops = gk._prod_i8_operands(U, c, inv, nona)
    digits = [ops[0]] if nona else [ops[0], ops[2]]
    for p, (X, d) in enumerate(zip(planes_np, digits)):
        np.testing.assert_array_equal(raw[p].numpy(),
                                      X.T @ d.numpy().astype(np.int64).T)
    assert torch.equal(raw, raw6) and torch.equal(out, out6)
    assert all(v == 0 for v in gk.launches.values())     # CPU: twins only


# tests/test_torch_geno_i8.py's shapes: n = 523, 1024, 77 are
# tests/test_pallas.py's; 1001..1003 cover n = 1, 2, 3 (mod 4)
@pytest.mark.parametrize("n,m", [(523, 300), (1024, 256), (77, 520),
                                 (1001, 130), (1002, 130), (1003, 130)])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_operator_matches_pallas_int8m_and_oracle(n, m, na_prob):
    jp = bt.snp_fake(n, m, seed=61, na_prob=na_prob)
    sc = bt.bed_scaleBinom(jp)
    scale = sc["scale"].copy()
    scale[::17] = 0.0                      # scale-0 variants contribute 0
    jop = pk.PallasOperator(jp, sc["center"], scale, interpret=True,
                            mxu="int8m")
    pop = pt.GenoOperator(interop.pack_from_numpy(np.asarray(jp.packed), n),
                          sc["center"], scale, mxu="int8m")
    assert pop.mxu == "int8m" and pop.nona == jop.nona == (na_prob == 0)
    assert (pop.planes[1] is None) == pop.nona
    rng = np.random.default_rng(0)
    V = rng.standard_normal((n, 8)).astype(np.float32)
    U = rng.standard_normal((m, 3)).astype(np.float32)
    Xt = dense(np.asarray(jp.packed), n, sc["center"], scale)
    B = pop.cprod(V)
    close(B, jop.cprod(V), JAX_TOL)
    close(B, Xt.T @ V, ORACLE_TOL)
    assert np.all(B[::17] == 0.0)
    Y = pop.prod(U)
    close(Y, jop.prod(U), JAX_TOL)
    close(Y, Xt @ U, ORACLE_TOL)
    Bp, Yp = pop.power(V)
    close(Yp, Xt @ (Xt.T @ V), ORACLE_TOL)
    close(Yp, jop.power(V)[1], JAX_TOL)
    # the int8 operator on the same pack gives the same floats
    p8 = pt.GenoOperator(interop.pack_from_numpy(np.asarray(jp.packed), n),
                         sc["center"], scale, mxu="int8")
    np.testing.assert_array_equal(p8.cprod(V), B)
    np.testing.assert_array_equal(p8.prod(U), Y)


@pytest.mark.parametrize("cls", ["geno", "torch"])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_int8m_masked_operator_equals_physical_subset(cls, na_prob):
    n, m = 223, 140
    jp = bt.snp_fake(n, m, seed=7, na_prob=na_prob)
    pp = interop.pack_from_numpy(np.asarray(jp.packed), n)
    rng = np.random.default_rng(3)
    ind_row = np.sort(rng.choice(n, size=150, replace=False))
    ind_col = np.sort(rng.choice(m, size=90, replace=False))
    jsub = jp.subset(ind_row=ind_row, ind_col=ind_col)
    sc = pt.bed_scaleBinom(pp, ind_row=ind_row)
    Xt = dense(np.asarray(jsub.packed), 150, sc["center"][ind_col],
               sc["scale"][ind_col])
    ctor = pt.GenoOperator if cls == "geno" else pt.TorchOperator
    op = ctor(pp, sc["center"], sc["scale"], ind_row=ind_row,
              ind_col=ind_col, mxu="int8m")
    jop = pk.PallasOperator(jp, sc["center"], sc["scale"], interpret=True,
                            ind_row=ind_row, ind_col=ind_col, mxu="int8m")
    V = rng.standard_normal((150, 4))
    close(op.cprod(V), Xt.T @ V, ORACLE_TOL)
    close(op.cprod(V), jop.cprod(V), JAX_TOL)
    U = rng.standard_normal((90, 4))
    close(op.prod(U), Xt @ U, ORACLE_TOL)
    close(op.prod(U), jop.prod(U), JAX_TOL)


def test_randomsvd_on_int8m_operator_matches_jax():
    """snp_randomSVD(None, {"center", "scale"}, op=int8m operator) in both
    packages, the JAX one on its Pallas operator in interpret mode (the
    only way its int8m scheme is reached)."""
    n, m = 400, 600
    jp = bt.snp_fake(n, m, seed=11, na_prob=0.02)
    sc = bt.bed_scaleBinom(jp)
    scd = {"center": sc["center"], "scale": sc["scale"]}
    jop = pk.PallasOperator(jp, sc["center"], sc["scale"], interpret=True,
                            mxu="int8m")
    jsvd = bt.snp_randomSVD(None, scd, op=jop, k=4, engine="device",
                            tol=1e-6)
    pop = pt.GenoOperator(interop.pack_from_numpy(np.asarray(jp.packed), n),
                          sc["center"], sc["scale"], mxu="int8m")
    psvd = pt.snp_randomSVD(None, scd, op=pop, k=4, tol=1e-6)
    np.testing.assert_allclose(psvd.d, jsvd.d, rtol=1e-4)
    cos = np.abs(np.sum(psvd.u * jsvd.u, axis=0))
    assert cos.min() >= 0.999, cos
    # the same SVD on the int8 operator: the products are bit-equal
    p8 = pt.GenoOperator(interop.pack_from_numpy(np.asarray(jp.packed), n),
                         sc["center"], sc["scale"], mxu="int8")
    s8 = pt.snp_randomSVD(None, scd, op=p8, k=4, tol=1e-6)
    np.testing.assert_array_equal(psvd.d, s8.d)
    np.testing.assert_array_equal(psvd.u, s8.u)


def test_wrappers_check_the_planes():
    n, m = 1001, 40
    P = torch.as_tensor(codes_pack(np.random.default_rng(1), n, m, 0.05))
    T, NA = gk.int8m_planes(P, n)
    c, inv, V = torch.ones(m), torch.ones(m), torch.zeros((n, 2))
    with pytest.raises(ValueError, match="columns"):
        gk.cprod_i8m((T[:, :1000].contiguous(), None), n, V, c, inv)
    with pytest.raises(ValueError, match="NA plane"):
        gk.cprod_i8m((T, NA[:5]), n, V, c, inv)
    with pytest.raises(TypeError, match="int8"):
        gk.cprod_i8m((T.to(torch.int32), None), n, V, c, inv)
    with pytest.raises(ValueError, match="operand"):
        gk.prod_i8m((T, NA), n, V, c, inv)
