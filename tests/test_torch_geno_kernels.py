"""Port parity: the fused decode + GEMM kernels K1 (cprod) and K2 (prod).

On the CPU the wrappers run their plain twins; these are held against the
JAX Pallas kernels run in interpret mode (`PallasOperator(interpret=True)`)
on the same packs and operands. Tolerance rtol = atol = 2e-4, as in
tests/test_pallas.py: both sides are float32 with other summation orders.
tests/test_torch_cuda.py holds the CUDA kernels against the twins on a
card."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.ops.pallas_kernels import PallasOperator
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import geno_kernels as gk

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def to_port(jpack):
    return interop.pack_from_numpy(np.asarray(jpack.packed), jpack.n)


def dense(pack, center, scale):
    """float64 oracle: (n, m) standardized with the scale-0 rule, NA -> 0."""
    X = pack.to_dosage()
    good = scale > 0
    Xt = (X - np.where(good, center, 2.0)) / np.where(good, scale, 1.0)
    Xt[:, ~good] = 0.0
    return np.nan_to_num(Xt, nan=0.0)


# n = 523, 1024, 77 are tests/test_pallas.py's shapes; 1001..1003 cover
# n = 1, 2, 3 (mod 4), whose last byte is partial
@pytest.mark.parametrize("n,m", [(523, 300), (1024, 256), (77, 520),
                                 (1001, 130), (1002, 130), (1003, 130)])
def test_twins_match_pallas_interpret(n, m):
    jp = bt.snp_fake(n, m, seed=61, na_prob=0.06)
    sc = bt.bed_scaleBinom(jp)
    scale = sc["scale"].copy()
    scale[::17] = 0.0                      # scale-0 variants contribute 0
    jop = PallasOperator(jp, sc["center"], scale, interpret=True)
    pop = pt.GenoOperator(to_port(jp), sc["center"], scale)
    assert (pop.n, pop.m) == (jop.n, jop.m) == (n, m)

    rng = np.random.default_rng(0)
    V = rng.standard_normal((n, 5))
    U = rng.standard_normal((m, 3))
    np.testing.assert_allclose(pop.cprod(V), jop.cprod(V), **TOL)
    np.testing.assert_allclose(pop.prod(U), jop.prod(U), **TOL)
    v = rng.standard_normal(n)
    np.testing.assert_allclose(pop.cprod(v), jop.cprod(v), **TOL)
    B, Y = pop.power(V)
    Bj, Yj = jop.power(V)
    np.testing.assert_allclose(B, Bj, **TOL)
    np.testing.assert_allclose(Y / np.abs(Yj).max(), Yj / np.abs(Yj).max(),
                               **TOL)
    Xt = dense(jp, sc["center"], scale)
    np.testing.assert_allclose(pop.cprod(V), Xt.T @ V, **TOL)
    assert np.all(pop.cprod(V)[::17] == 0.0)


def test_partial_last_byte_pad_bits_do_not_count():
    """Code 00 in the pad bits would decode as dosage 2: the twins (and
    the kernels) must ignore samples >= n."""
    rng = np.random.default_rng(2)
    for n in (5, 6, 7):
        codes = rng.choice(np.array([0, 2, 3], np.uint8), size=(9, n))
        packed = junpack.np_pack_codes(codes)
        center, inv = np.full(9, 0.5), np.full(9, 2.0)
        d = (2 - ((codes.astype(int) + 1) >> 1)).astype(float)
        Xt = (d - 0.5) * 2.0                        # (m, n)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
        V = rng.standard_normal((n, 3))
        out = gk.cprod(torch.as_tensor(packed), n, t(V), t(center), t(inv))
        np.testing.assert_allclose(out.numpy(), Xt @ V, rtol=1e-5, atol=1e-5)
        U = rng.standard_normal((9, 2))
        out = gk.prod(torch.as_tensor(packed), n, t(U), t(center), t(inv))
        np.testing.assert_allclose(out.numpy(), Xt.T @ U, rtol=1e-5, atol=1e-5)


def test_monomorphic_and_na_variants():
    """As tests/test_pallas.py::test_pallas_monomorphic_and_na."""
    rng = np.random.default_rng(1)
    X = rng.binomial(2, 0.3, size=(100, 40)).astype(float)
    X[rng.random((100, 40)) < 0.1] = np.nan
    X[:, 7] = 2.0
    packed = junpack.np_pack_codes(junpack.np_dosage_to_codes(X.T))
    jp = JaxGenoPack(packed=packed, n=100)
    sc = bt.bed_scaleBinom(jp)
    pop = pt.GenoOperator(interop.pack_from_numpy(packed, 100), sc["center"],
                          sc["scale"])
    out = pop.cprod(np.ones(100))
    assert out[7] == 0.0
    jop = PallasOperator(jp, sc["center"], sc["scale"], interpret=True)
    np.testing.assert_allclose(out, jop.cprod(np.ones(100)), **TOL)


@pytest.mark.parametrize("cls", ["geno", "torch"])
def test_masked_operator_equals_physical_subset(cls):
    """As tests/test_pallas.py:55: ind_row/ind_col masking on the whole
    pack acts exactly as the physically subsetted matrix."""
    n, m = 223, 140
    jp = bt.snp_fake(n, m, seed=7, na_prob=0.05)
    pp = to_port(jp)
    rng = np.random.default_rng(3)
    ind_row = np.sort(rng.choice(n, size=150, replace=False))
    ind_col = np.sort(rng.choice(m, size=90, replace=False))

    jsub = jp.subset(ind_row=ind_row, ind_col=ind_col)
    sc_sub = bt.bed_scaleBinom(jsub)
    Xt = dense(jsub, sc_sub["center"], sc_sub["scale"])

    sc = pt.bed_scaleBinom(pp, ind_row=ind_row)
    ctor = pt.GenoOperator if cls == "geno" else pt.TorchOperator
    op = ctor(pp, sc["center"], sc["scale"], ind_row=ind_row, ind_col=ind_col)
    assert (op.n, op.m) == (150, 90)
    V = rng.standard_normal((150, 4))
    np.testing.assert_allclose(op.cprod(V), Xt.T @ V, **TOL)
    U = rng.standard_normal((90, 4))
    np.testing.assert_allclose(op.prod(U), Xt @ U, **TOL)
    B, Y = op.power(V)
    np.testing.assert_allclose(B, Xt.T @ V, **TOL)
    np.testing.assert_allclose(Y, Xt @ (Xt.T @ V), rtol=2e-4, atol=3e-3)


def test_wrappers_take_twins_on_cpu_and_check_inputs():
    pp = pt.snp_fake(30, 12, seed=9, na_prob=0.1)
    packed = pp.device_packed("cpu")
    c = torch.zeros(12)
    inv = torch.ones(12)
    V = torch.randn(30, 3)
    before = dict(gk.launches)
    torch.testing.assert_close(gk.cprod(packed, 30, V, c, inv),
                               gk.cprod_plain(packed, 30, V, c, inv))
    U = torch.randn(12, 3)
    assert torch.equal(gk.prod(packed, 30, U, c, inv),
                       gk.prod_plain(packed, 30, U, c, inv))
    assert gk.launches == before            # no kernel ran
    with pytest.raises(ValueError):
        gk.cprod(packed, 30, V.double(), c, inv)
    with pytest.raises(ValueError, match="bytes per variant"):
        gk.cprod(packed, 26, torch.randn(26, 3), c, inv)
    with pytest.raises(ValueError):
        gk.prod(packed, 30, torch.randn(3, 12).T, c, inv)  # not contiguous
    with pytest.raises(TypeError):
        gk.prod(packed.to(torch.int16), 30, torch.randn(12, 2), c, inv)
