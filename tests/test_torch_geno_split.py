"""Port parity: the "split2" scheme of the genotype operator (kernel K7).

On the CPU the wrappers run their plain twins (`cprod_split_plain`,
`prod_split_plain`); these are held against the JAX package's split2
Pallas kernels run in interpret mode (`PallasOperator(interpret=True,
mxu="split2")`) within 1e-5 of max |ref| (both float32; the sums run in
another order, per sample tile there, whole here), and against a float64
dense oracle within 2e-5 of max |oracle| (tests/test_pallas.py's bound for
split2). `split_bf16` is bit-equal to `_split_bf16`. The same plane
algebra with the operand split into three bf16 terms, which K2 (the
"highest" prod) runs on the card, centred, is held against the JAX
package's f32-HIGHEST kernels and float64 within 1e-5, also on operands
of mean far from zero, and `plane_plan`, the two
kernels' launch plan, against the C side's checks.
tests/test_torch_cuda.py holds the CUDA kernels against the twins on a
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


# ---------------------------------------------------------------------------
# the three-term plane algebra of K2 (the "highest" prod on bit planes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l", [1, 12, 21])
def test_split_bf16_three_terms_hold_every_bit(l):
    """hi + mid + lo is x to within 2^-24 of |x| (all 24 bits of the f32
    mantissa), each cast rounding to nearest even; two terms stay
    `split_bf16(x)` bit for bit."""
    rng = np.random.default_rng(l + 100)
    y = (rng.standard_normal((l, 517)) * rng.uniform(1e-6, 1e6, (l, 1))
         ).astype(np.float32)
    y[0, :3] = (0.0, -0.0, 1.0 + 2.0 ** -8 + 2.0 ** -17)
    x = torch.as_tensor(y)
    hi, mid, lo = gk.split_bf16(x, terms=3)
    r = x - hi.to(torch.float32)
    assert torch.equal(mid, r.to(torch.bfloat16))
    assert torch.equal(lo, (r - mid.to(torch.float32)).to(torch.bfloat16))
    total = (hi.double() + mid.double()) + lo.double()
    assert ((total - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    for a, b in zip(gk.split_bf16(x, terms=2), gk.split_bf16(x)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("n,m", [(1000, 130), (1001, 257), (1002, 130),
                                 (1003, 200)])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_three_term_algebra_matches_pallas_highest_and_oracle(n, m, na_prob):
    """The plain three-term plane algebra (`prod_split_plain(terms=3)`,
    the function K2 computes on the card; and its cprod) against the JAX
    package's f32-HIGHEST Pallas kernels in interpret mode on the same
    numpy inputs, within 1e-5 of max |ref| (f32 sums in other orders), and
    against float64 within 1e-5 of max |oracle|; monomorphic and scale-0
    variants, n = 0..3 (mod 4)."""
    jp = bt.snp_fake(n, m, seed=n + 7, na_prob=na_prob)
    packed = np.asarray(jp.packed).copy()
    packed[5] = 0                                    # monomorphic
    jp = bt.GenoPack(packed=packed, n=n)
    sc = bt.bed_scaleBinom(jp)
    scale = scale_with_zeros(sc)
    jop = pk.PallasOperator(jp, sc["center"], scale, interpret=True,
                            mxu="highest")
    pop = pt.GenoOperator(interop.pack_from_numpy(packed, n), sc["center"],
                          scale)
    P, c, inv = pop.packed, pop.center, pop.inv
    rng = np.random.default_rng(1)
    U = rng.standard_normal((m, 20)).astype(np.float32)
    V = rng.standard_normal((n, 12)).astype(np.float32)
    Xt = dense(packed, n, sc["center"], scale)
    Y = gk.prod_split_plain(P, n, torch.as_tensor(U), c, inv, terms=3).numpy()
    close(Y, jop.prod(U), JAX_TOL)
    close(Y, Xt @ U.astype(np.float64), 1e-5)
    B = gk.cprod_split_plain(P, n, torch.as_tensor(V), c, inv,
                             terms=3).numpy()
    close(B, jop.cprod(V), JAX_TOL)
    close(B, Xt.T @ V.astype(np.float64), 1e-5)
    assert np.all(B[::17] == 0.0)


@pytest.mark.parametrize("kind", ["|N|+1", "ones", "-|N|-1"])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_three_term_algebra_holds_operands_of_nonzero_mean(kind, na_prob):
    """An operand whose columns do not average zero (all-positive
    weights, U = 1) makes the plane sums grow like m and the result like
    sqrt(m): the centred three-term algebra (K2's) stays within 1e-5 of
    max |float64| as the direct f32 twin does, at 40,000 variants, one
    sample with a fifth of its genotypes missing."""
    n, m = 203, 40_000
    jp = bt.snp_fake(n, m, seed=11, na_prob=na_prob)
    packed = np.asarray(jp.packed).copy()
    packed[:m // 5, 0] |= 0x03
    packed[:m // 5, 0] &= 0xFD                     # sample 0: NA (code 1)
    sc = bt.bed_scaleBinom(bt.GenoPack(packed=packed, n=n))
    scale = scale_with_zeros(sc)
    pop = pt.GenoOperator(interop.pack_from_numpy(packed, n), sc["center"],
                          scale)
    P, c, inv = pop.packed, pop.center, pop.inv
    rng = np.random.default_rng(3)
    U = {"|N|+1": np.abs(rng.standard_normal((m, 12))) + 1,
         "ones": np.ones((m, 1)),
         "-|N|-1": -np.abs(rng.standard_normal((m, 12))) - 1}[kind]
    U = torch.as_tensor(U.astype(np.float32))
    ref64 = dense(packed, n, sc["center"], scale) @ U.double().numpy()
    Y = gk.prod_split_plain(P, n, U, c, inv, terms=3).numpy()
    close(Y, ref64, 1e-5)
    close(gk.prod_plain(P, n, U, c, inv).numpy(), ref64, 1e-5)
    assert np.abs(ref64[0]).max() > 0


# ---------------------------------------------------------------------------
# the launch plan of the K2 / K7 GEMM (`plane_plan`), at the card tests'
# shapes and the chip's
# ---------------------------------------------------------------------------

# the N widths of wgmma .f32.bf16.bf16 (PTX ISA: m64nNk16, N a multiple of
# 8 up to 256)
BF16_WIDTHS = set(range(8, 257, 8))
PLANE_SMEM = 232_448


def plane_refused(plan, prod, terms, m, n, l):
    """The conditions under which `geno_plane_gemm` refuses a plan (rc -1),
    in Python: a plan from `plane_plan` must pass them."""
    M, K = (n, m) if prod else (m, n)
    ks = plan["ksub"]
    ktiles = -(-K // (64 * ks))
    bn, nt = plan["bn"], plan["n_tiles"]
    rows, raw = (64 * ks, 48) if prod else (128, max(48, 16 * (ks + 1)))
    smem = 2048 + plan["stages"] * ((2 if prod else 1) * ks * terms * bn
                                    * 128 + rows * raw)
    return (bn not in gk.PLANE_BNC[terms] or bn % 8 or terms * bn > 96
            or nt * bn != plan["l_pad"]
            or nt * plan["cols"] < l or (nt - 1) * plan["cols"] >= l
            or plan["cols"] != bn - (1 if prod and terms == 3 else 0)
            or ks not in (1, 2, 4) or not 2 <= plan["stages"] <= 8
            or plan["kps"] < 1
            or -(-ktiles // plan["kps"]) != plan["splits"]
            or plan["grid"] < 1 or smem > PLANE_SMEM
            or smem != plan["smem"])


@pytest.mark.parametrize("l", [1, 12, 20, 50, 120, 650])
@pytest.mark.parametrize("n", [1001, 1009, 4099, 15_000, 20_000, 50_000])
@pytest.mark.parametrize("prod,terms", [(False, 2), (True, 2), (True, 3)])
def test_plane_plan_covers_the_product_once(l, n, prod, terms):
    """Every tile of M x l is covered by one item a depth split and its
    depth tiles once; the width is compiled and a bf16 wgmma width; the
    stages fit in shared memory; the C side's checks pass; the same with
    the card test's forced splits (1-16)."""
    from test_torch_geno_i8 import walk

    m = 100_000 if n >= 15_000 else 3001
    M, K = (n, m) if prod else (m, n)
    for splits in (None, 1, 2, 5, 16):
        plan = gk.plane_plan(prod, terms, m, n, l, 132, splits)
        assert not plane_refused(plan, prod, terms, m, n, l)
        assert terms * plan["bn"] in BF16_WIDTHS
        assert (plan["m_tiles"] - 1) * 128 < M <= plan["m_tiles"] * 128
        assert plan["ktiles"] == -(-K // (64 * plan["ksub"]))
        assert 1 <= plan["splits"] <= min(plan["ktiles"], 16)
        assert 1 <= plan["grid"] <= 132
        if splits is None and plan["splits"] > 1:
            # split only to fill the last wave of CTAs to 90%
            tiles = plan["m_tiles"] * plan["n_tiles"]
            s = plan["splits"] - 1
            assert tiles * s < 0.9 * -(-(tiles * s) // 132) * 132
        if M > 20_000:
            continue                   # the walk below is slow at 50,000
        seen = walk(plan, M, K)
        tiles = {(mt, t) for mt in range(plan["m_tiles"])
                 for t in range(plan["n_tiles"])}
        assert len(seen) == len(tiles) * plan["splits"]
        for tile in tiles:
            runs = sorted((k0, k1) for mt, t, k0, k1 in seen
                          if (mt, t) == tile)
            assert runs[0][0] == 0 and runs[-1][1] == plan["ktiles"]
            assert all(a[1] == b[0] and a[0] < a[1]
                       for a, b in zip(runs, runs[1:]))


def test_plane_plan_at_the_main_path_shapes():
    """The plans the chip's shapes get: l <= 31 (K2, whose tile of 32
    ends in its count column) or 40 (K7) is one column tile (the pack
    decoded once an item); slice 1's 50,000-sample prod fills the card
    unsplit; the grid PRS's l = 650 takes 21 tiles of 32 (31 columns
    each) under K2."""
    p = gk.plane_plan(True, 3, 100_000, 50_000, 20, 132)
    assert (p["bn"], p["n_tiles"], p["splits"]) == (24, 1, 1)
    assert p["ksub"] == 4 and p["stages"] >= 2
    p = gk.plane_plan(True, 3, 100_000, 50_000, 1, 132)
    assert (p["bn"], p["n_tiles"], p["splits"]) == (8, 1, 1)
    p = gk.plane_plan(True, 3, 100_000, 50_000, 50, 132)
    assert (p["bn"], p["n_tiles"], p["splits"]) == (32, 2, 1)
    p = gk.plane_plan(True, 3, 100_000, 15_000, 650, 132)
    assert (p["bn"], p["n_tiles"], p["l_pad"], p["cols"]) == (32, 21, 672,
                                                              31)
    assert p["stages"] >= 2
    p = gk.plane_plan(False, 2, 100_000, 50_000, 20, 132)
    assert (p["bn"], p["n_tiles"], p["splits"], p["ksub"]) == (24, 1, 1, 4)
    for terms, widest in ((2, 40), (3, 31)):
        for l in range(1, widest + 1):
            assert gk.plane_plan(True, terms, 100_000, 20_000, l,
                                 132)["n_tiles"] == 1

