"""Port parity: the "split2" scheme of the genotype operator (kernel K7).

On the CPU the wrappers run their plain twins (`cprod_split_plain`,
`prod_split_plain`); these are held against the JAX package's split2
Pallas kernels run in interpret mode (`PallasOperator(interpret=True,
mxu="split2")`) within 1e-5 of max |ref| (both float32; the sums run in
another order, per sample tile there, whole here), and against a float64
dense oracle within 2e-5 of max |oracle| (tests/test_pallas.py's bound for
split2). `split_bf16` is bit-equal to `_split_bf16`.
tests/test_torch_cuda.py holds the CUDA kernel against the twins on a
card."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
import jax.numpy as jnp
from bigsnpr_tpu import config as jconfig
from bigsnpr_tpu.ops import pallas_kernels as pk
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.linalg import randomsvd as prsvd
from bigsnpr_tpu_torch.ops import geno_kernels as gk

from test_torch_geno_i8 import close, dense

torch.set_num_threads(2)
JAX_TOL = 1e-5
ORACLE_TOL = 2e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


@pytest.mark.parametrize("l", [1, 12, 21])
def test_split_bf16_bit_equal_to_jax(l):
    rng = np.random.default_rng(l)
    y = (rng.standard_normal((l, 517)) * rng.uniform(1e-6, 1e6, (l, 1))
         ).astype(np.float32)
    y[0, :3] = (0.0, -0.0, 1.0 + 2.0 ** -8)        # zeros and a tie
    jhi, jlo = pk._split_bf16(jnp.asarray(y))
    thi, tlo = gk.split_bf16(torch.as_tensor(y))
    for t, j in ((thi, jhi), (tlo, jlo)):
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(j).view(np.int16))


def scale_with_zeros(sc, every=17):
    scale = sc["scale"].copy()
    scale[::every] = 0.0                   # scale-0 variants contribute 0
    return scale


# n = 0, 1, 2, 3 (mod 4); NA and NA-free packs; a monomorphic variant
@pytest.mark.parametrize("n,m", [(1000, 130), (1001, 257), (1002, 130),
                                 (1003, 200)])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_operator_matches_pallas_split2_and_oracle(n, m, na_prob):
    jp = bt.snp_fake(n, m, seed=n, na_prob=na_prob)
    packed = np.asarray(jp.packed).copy()
    packed[5] = 0                                    # monomorphic
    jp = bt.GenoPack(packed=packed, n=n)
    sc = bt.bed_scaleBinom(jp)
    scale = scale_with_zeros(sc)
    jop = pk.PallasOperator(jp, sc["center"], scale, interpret=True,
                            mxu="split2")
    pop = pt.GenoOperator(interop.pack_from_numpy(packed, n), sc["center"],
                          scale, mxu="split2")
    assert pop.mxu == "split2"
    rng = np.random.default_rng(0)
    V = rng.standard_normal((n, 12)).astype(np.float32)
    U = rng.standard_normal((m, 21)).astype(np.float32)
    Xt = dense(packed, n, sc["center"], scale)
    B = pop.cprod(V)
    close(B, jop.cprod(V), JAX_TOL)
    close(B, Xt.T @ V, ORACLE_TOL)
    assert np.all(B[::17] == 0.0)
    Y = pop.prod(U)
    close(Y, jop.prod(U), JAX_TOL)
    close(Y, Xt @ U, ORACLE_TOL)
    Bp, Yp = pop.power(V[:, :1])
    jB, jY = jop.power(V[:, :1])
    close(Bp, jB, JAX_TOL)
    close(Yp, jY, JAX_TOL)
    close(Yp, Xt @ (Xt.T @ V[:, :1]), ORACLE_TOL)


@pytest.mark.parametrize("cls", ["geno", "torch"])
def test_split2_masked_operator_matches_pallas(cls):
    """ind_row / ind_col scattered and gathered around the twins, against
    the masked JAX operator and the physically subsetted oracle."""
    n, m = 523, 300
    jp = bt.snp_fake(n, m, seed=7, na_prob=0.05)
    pp = interop.pack_from_numpy(np.asarray(jp.packed), n)
    rng = np.random.default_rng(3)
    ind_row = np.sort(rng.choice(n, size=400, replace=False))
    ind_col = np.sort(rng.choice(m, size=170, replace=False))
    sc = pt.bed_scaleBinom(pp, ind_row=ind_row)
    jop = pk.PallasOperator(jp, sc["center"], sc["scale"], interpret=True,
                            mxu="split2", ind_row=ind_row, ind_col=ind_col)
    ctor = pt.GenoOperator if cls == "geno" else pt.TorchOperator
    op = ctor(pp, sc["center"], sc["scale"], ind_row=ind_row,
              ind_col=ind_col, mxu="split2")
    jsub = jp.subset(ind_row=ind_row, ind_col=ind_col)
    Xt = dense(np.asarray(jsub.packed), 400, sc["center"][ind_col],
               sc["scale"][ind_col])
    V = rng.standard_normal((400, 20)).astype(np.float32)
    B, Y = op.power(V)
    jB, jY = jop.power(V)
    close(B, jB, JAX_TOL)
    close(Y, jY, JAX_TOL)
    close(B, Xt.T @ V, ORACLE_TOL)
    U = rng.standard_normal((170, 3))
    close(op.prod(U), jop.prod(U), JAX_TOL)


def test_randomsvd_and_gwas_under_split2_match_jax():
    """The scheme reaches snp_randomSVD and big_univLinReg through the
    scheme-keyed operator cache; both match the JAX package's split2
    runs, and the CPU runs the twins only (no kernel launch)."""
    n, m = 401, 600
    jp = bt.snp_fake(n, m, seed=11, na_prob=0.02)
    pp = interop.pack_from_numpy(np.asarray(jp.packed), n)
    rows = np.arange(0, n, 2)
    before = dict(gk.launches)
    with jconfig.options(pallas_mxu="split2"):
        jsvd = bt.snp_randomSVD(jp, k=3, ind_row=rows, tol=1e-7,
                                engine="pallas")
    with pt.config.options(pallas_mxu="split2"):
        psvd = pt.snp_randomSVD(pp, k=3, ind_row=rows, tol=1e-7)
        op = prsvd._cached_op(pp, pt.GenoOperator, psvd.center, psvd.scale,
                              rows, None, device="cpu")
        y = np.random.default_rng(1).standard_normal(len(rows))
        g = pt.big_univLinReg(pp, y, covar=psvd.u, ind_row=rows)
    assert op.mxu == "split2"
    np.testing.assert_allclose(psvd.d, jsvd.d, rtol=1e-4)
    jg = bt.big_univLinReg(jp, y, covar=psvd.u, ind_row=rows)
    for key in ("estim", "std.err"):
        ref = jg[key].to_numpy()
        np.testing.assert_allclose(g[key], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    assert gk.launches == before
