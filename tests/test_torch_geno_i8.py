"""Port parity: the "int8" scheme of the genotype operator (kernel K6).

On the CPU the wrappers run their plain twins (`cprod_i8_plain`,
`prod_i8_plain`); these are held against the JAX package's int8 Pallas
kernels run in interpret mode (`PallasOperator(interpret=True,
mxu="int8")`) within 1e-5 of max |ref| (both float32, combined per sample
tile there and once here), against a float64 dense oracle within 5e-6 of
max |oracle| (tests/test_pallas.py's bound), and their integer digit sums
against an int64 numpy oracle, exactly. tests/test_torch_cuda.py holds
the CUDA kernel against the twins on a card."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
import jax.numpy as jnp
from bigsnpr_tpu import config as jconfig
from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.ops import pallas_kernels as pk
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.linalg import randomsvd as prsvd
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


@pytest.mark.parametrize("l", [1, 7, 20])
def test_int8_planes_bit_equal_to_jax(l):
    rng = np.random.default_rng(l)
    y = (rng.standard_normal((l, 517)) * rng.uniform(1e-3, 1e3, (l, 1))
         ).astype(np.float32)
    y[0, :] = 0.0                                    # a zero row: scale 1
    y[-1, 3] = 0.5                                   # ties round to even
    jd, js = pk._int8_planes(jnp.asarray(y))
    td, ts = gk.int8_planes(torch.as_tensor(y))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n", [1000, 1001, 1002, 1003])
@pytest.mark.parametrize("nona", [False, True])
def test_raw_sums_equal_int64_oracle(n, nona):
    """The twins' digit sums against int64 numpy products of the decoded
    planes with the same digits; n = 0..3 (mod 4)."""
    rng = np.random.default_rng(n)
    m, l = 150, 6
    packed = codes_pack(rng, n, m, 0.0 if nona else 0.05)
    g = junpack.np_unpack_codes(packed, n).astype(np.int64)
    b0, b1 = g & 1, g >> 1
    T, NA = b1 + (b0 & b1), b0 & ~b1 & 1
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    c, inv = t(rng.uniform(0, 2, m)), t(rng.uniform(0.5, 2, m))
    V, U = t(rng.standard_normal((n, l))), t(rng.standard_normal((m, l)))
    P = torch.as_tensor(packed)
    _, raw = gk.cprod_i8(P, n, V, c, inv, nona=nona, return_raw=True)
    q8 = gk._cprod_i8_operands(V, c, inv)[0].numpy().astype(np.int64)
    planes = [T] if nona else [T, NA]
    for p, X in enumerate(planes):
        np.testing.assert_array_equal(raw[p].numpy(), X @ q8.T)
    _, raw = gk.prod_i8(P, n, U, c, inv, nona=nona, return_raw=True)
    ops = gk._prod_i8_operands(U, c, inv, nona)
    digits = [ops[0]] if nona else [ops[0], ops[2]]
    for p, (X, d) in enumerate(zip(planes, digits)):
        np.testing.assert_array_equal(raw[p].numpy(),
                                      X.T @ d.numpy().astype(np.int64).T)


# n = 523, 1024, 77 are tests/test_pallas.py's shapes; 1001..1003 cover
# n = 1, 2, 3 (mod 4)
@pytest.mark.parametrize("n,m", [(523, 300), (1024, 256), (77, 520),
                                 (1001, 130), (1002, 130), (1003, 130)])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_operator_matches_pallas_int8_and_oracle(n, m, na_prob):
    jp = bt.snp_fake(n, m, seed=61, na_prob=na_prob)
    sc = bt.bed_scaleBinom(jp)
    scale = sc["scale"].copy()
    scale[::17] = 0.0                      # scale-0 variants contribute 0
    jop = pk.PallasOperator(jp, sc["center"], scale, interpret=True,
                            mxu="int8")
    pop = pt.GenoOperator(interop.pack_from_numpy(np.asarray(jp.packed), n),
                          sc["center"], scale, mxu="int8")
    assert pop.mxu == "int8" and pop.nona == jop.nona == (na_prob == 0)
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
    close(Bp, Xt.T @ V, ORACLE_TOL)
    close(Yp, Xt @ (Xt.T @ V), ORACLE_TOL)
    close(Yp, jop.power(V)[1], JAX_TOL)


@pytest.mark.parametrize("cls", ["geno", "torch"])
def test_int8_masked_operator_equals_physical_subset(cls):
    n, m = 223, 140
    jp = bt.snp_fake(n, m, seed=7, na_prob=0.05)
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
              ind_col=ind_col, mxu="int8")
    V = rng.standard_normal((150, 4))
    close(op.cprod(V), Xt.T @ V, ORACLE_TOL)
    U = rng.standard_normal((90, 4))
    close(op.prod(U), Xt @ U, ORACLE_TOL)


def test_nona_detection_matches_jax():
    """One NA code anywhere turns the NA-free path off, in both packages;
    the zero pad bits of a partial last byte are not NA."""
    rng = np.random.default_rng(7)
    m, n = 64, 1001
    codes = rng.choice(np.array([0, 2, 3], np.uint8), size=(m, n))
    c, s = rng.uniform(0.2, 1.8, m), rng.uniform(0.3, 1.0, m)
    for where in (None, (0, 0), (m - 1, n - 1), (31, 500)):
        cc = codes.copy()
        if where is not None:
            cc[where] = 1
        packed = junpack.np_pack_codes(cc)
        jop = pk.PallasOperator(JaxGenoPack(packed=packed, n=n), c, s,
                                interpret=True, mxu="int8")
        pop = pt.GenoOperator(interop.pack_from_numpy(packed, n), c, s,
                              mxu="int8")
        assert pop.nona == jop.nona == (where is None)
    assert not pt.GenoOperator(interop.pack_from_numpy(packed, n), c, s,
                               mxu="int8", nona=False).nona


def test_cached_op_follows_pallas_mxu():
    """_cached_op keys on the scheme: a change of pallas_mxu between calls
    builds a new operator (the JAX key has no scheme: ROADMAP queue 3)."""
    pp = pt.snp_fake(300, 200, seed=2, na_prob=0.05)
    sc = pt.bed_scaleBinom(pp)
    ops = {}
    for mxu in ("highest", "int8", "highest"):
        with pt.config.options(pallas_mxu=mxu):
            ops.setdefault(mxu, []).append(prsvd._cached_op(
                pp, pt.GenoOperator, sc["center"], sc["scale"], None, None,
                device="cpu"))
    assert ops["int8"][0].mxu == "int8"
    assert ops["highest"][0].mxu == ops["highest"][1].mxu == "highest"
    assert ops["highest"][0] is ops["highest"][1]
    assert ops["int8"][0] is not ops["highest"][0]
    before = dict(gk.launches)
    with pt.config.options(pallas_mxu="int8"):
        svd8 = pt.snp_randomSVD(pp, k=3)
    svd = pt.snp_randomSVD(pp, k=3)
    np.testing.assert_allclose(svd8.d, svd.d, rtol=1e-4)
    assert gk.launches == before            # CPU: twins only


def test_schemes_not_ported_raise():
    """"split2" (K7) is accepted since slice 4. "int8m" (K8, slice 5) is
    refused by the option in both packages and reached through the
    operator's constructor, which accepts it."""
    assert jconfig.get_option("pallas_mxu") == pt.config.get_option(
        "pallas_mxu") == "highest"
    with pt.config.options(pallas_mxu="split2"):
        assert pt.config.resolve_mxu() == "split2"
    with pytest.raises(AssertionError):
        jconfig.set_option("pallas_mxu", "int8m")
    with pytest.raises(ValueError, match=r'GenoOperator\(.*mxu="int8m"\)'):
        pt.config.set_option("pallas_mxu", "int8m")
    with pytest.raises(ValueError):
        pt.config.set_option("pallas_mxu", "bf16")
    pp = pt.snp_fake(20, 10, seed=1)
    for ctor in (pt.GenoOperator, pt.TorchOperator):
        op = ctor(pp, np.ones(10), np.ones(10), mxu="int8m")
        assert op.mxu == "int8m" and op.planes[0].shape == (10, 32)
    with pytest.raises(ValueError):
        pt.GenoOperator(pp, np.ones(10), np.ones(10), mxu="bf16")
    assert pt.GenoOperator(pp, np.ones(10), np.ones(10),
                           mxu="split2").mxu == "split2"
    assert pt.config.get_option("pallas_mxu") == "highest"
    assert jconfig.get_option("pallas_mxu") == "highest"


def test_overflow_guard_raises():
    n = gk.MAX_I8_DEPTH + 4
    packed = torch.zeros((1, n // 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="overflow"):
        gk.cprod_i8(packed, n, torch.zeros((n, 1)), torch.ones(1),
                    torch.ones(1))


# ---------------------------------------------------------------------------
# the launch plan of the K6 / K8 GEMM (`i8_plan`), at the card tests' shapes
# and at the chip's (slice 3's 50,000 x 100,000 at l = 12 and 20; slices 4
# and 5's 20,000 x 100,000)
# ---------------------------------------------------------------------------

# the N widths of wgmma .s32.s8.s8 (PTX ISA: m64nNk32)
S8_WIDTHS = {8, 16, 24, 32} | set(range(48, 257, 16))
PLAN_SHAPES = [(1000, 777, 1), (1001, 1500, 12), (1002, 3001, 20),
               (4099, 513, 21), (1001, 700, 65), (1009, 1500, 20),
               (50_000, 100_000, 12), (50_000, 100_000, 20),
               (20_000, 100_000, 20)]
KINDS = [(prod, nona, mat) for prod in (False, True)
         for nona in (False, True) for mat in (False, True)]


def walk(plan, M, K):
    """The work items as the kernel's persistent CTAs walk them: each
    CTA b takes items b, b + grid, ...; an item is (M tile, column tile,
    depth split) and covers rows, columns and depth tiles."""
    per_split = plan["m_tiles"] * plan["n_tiles"]
    items = per_split * plan["splits"]
    seen = []
    for b in range(plan["grid"]):
        for item in range(b, items, plan["grid"]):
            sp, rem = divmod(item, per_split)
            nt, mt = divmod(rem, plan["m_tiles"])
            k0 = sp * plan["kps"]
            seen.append((mt, nt, k0, min(plan["ktiles"], k0 + plan["kps"])))
    return seen


@pytest.mark.parametrize("n,m,l", PLAN_SHAPES)
@pytest.mark.parametrize("prod,nona,mat", KINDS)
def test_i8_plan_covers_the_product_once(n, m, l, prod, nona, mat):
    """Tiles cover M x padded N exactly once and the depth once an item;
    a tile is at most 256 wide and a width .s8 wgmma allows; splits <=
    depth tiles; raw is zeroed exactly when the depth is split; the stages
    fit in shared memory; the same with the card test's forced splits."""
    M, K, N4 = (n, m, 4 * l) if prod else (m, n, 4 * l)
    for splits in (None, 1, 2, 5, 16):
        plan = gk.i8_plan(prod, nona, mat, m, n, l, 132, splits)
        bn, nt = plan["bn"], plan["n_tiles"]
        assert bn <= 256 and bn in S8_WIDTHS and bn in gk.I8_WIDTHS
        assert plan["n_pad"] == bn * nt and (nt - 1) * bn < N4 <= bn * nt
        bm = plan["bm"]
        assert (plan["m_tiles"] - 1) * bm < M <= plan["m_tiles"] * bm
        assert plan["ktiles"] == -(-K // 128)
        assert 1 <= plan["splits"] <= plan["ktiles"]
        assert plan["zero_raw"] == (plan["splits"] > 1)
        assert 2 <= plan["stages"] <= gk.I8_MAX_STAGES
        assert plan["smem"] <= gk.I8_SMEM
        assert 1 <= plan["grid"] <= 132
        seen = walk(plan, M, K)
        tiles = {(mt, t) for mt in range(plan["m_tiles"]) for t in range(nt)}
        for tile in tiles:
            runs = sorted((k0, k1) for mt, t, k0, k1 in seen
                          if (mt, t) == tile)
            assert runs[0][0] == 0 and runs[-1][1] == plan["ktiles"]
            assert all(k0 < k1 for k0, k1 in runs)
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        assert len(seen) == len(tiles) * plan["splits"]
        if splits is not None:
            assert plan["splits"] <= splits


def test_i8_plan_at_the_chip_shapes():
    """At 50,000 x 100,000 the full depth runs unsplit into plain stores
    (782 and 391 128-row tiles fill their last waves of 132 CTAs) except
    in the NA-free prods, whose 196 256-row tiles fill 1.5 waves and split
    the depth in two; prod at 20,000 samples (157 tiles) splits the
    depth; the ring keeps >= 4 stages at l = 20."""
    for prod in (False, True):
        for nona in (False, True):
            for mat in (False, True):
                plan = gk.i8_plan(prod, nona, mat, 100_000, 50_000, 20, 132)
                wide = prod and nona
                assert plan["bm"] == (256 if wide else 128)
                assert plan["splits"] == (2 if wide else 1)
                assert plan["zero_raw"] == wide
                assert plan["bn"] == 80 and plan["n_tiles"] == 1
                assert plan["stages"] >= 4
                short = gk.i8_plan(True, nona, mat, 100_000, 20_000, 20, 132)
                assert short["splits"] > 1 and short["zero_raw"]
