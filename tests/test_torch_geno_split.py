"""Port parity: the "split2" scheme of the genotype operator (kernel K7).

On the CPU the wrappers run their plain twins (`cprod_split_plain`,
`prod_split_plain`); these are held against the JAX package's split2
Pallas kernels run in interpret mode (`PallasOperator(interpret=True,
mxu="split2")`) within 1e-5 of max |ref| (both float32; the sums run in
another order, per sample tile there, whole here), and against a float64
dense oracle within 2e-5 of max |oracle| (tests/test_pallas.py's bound for
split2). `split_bf16` is bit-equal to `_split_bf16`. The same plane
algebra with the operand split into three bf16 terms, which K2 and K1
(the "highest" prod and cprod) run on the card, centred, is held against
the JAX package's f32-HIGHEST kernels and float64 within 1e-5, also on
operands of mean far from zero and on the GWAS operand [yr | Q]; K1's
operand preparation is emulated as the C side writes it and held equal to
the twin's; and `plane_plan`, the kernels' launch plan, against the C
side's checks.
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

from bigsnpr_tpu.core import unpack as junpack
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
# the three-term plane algebra of K2 and K1 (the "highest" prod and cprod on
# bit planes)
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
    """The plain three-term plane algebra (`prod_split_plain(terms=3)` and
    `cprod_split_plain(terms=3)`, the functions K2 and K1 compute on the
    card, centred) against the JAX package's f32-HIGHEST Pallas kernels in
    interpret mode on the same numpy inputs, within 1e-5 of max |ref| (f32
    sums in other orders), and against float64 within 1e-5 of max
    |oracle|; monomorphic and scale-0 variants, n = 0..3 (mod 4); cprod
    also on V = |N(0,1)| + 1, where its centring shifts every column."""
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
    Vm = np.abs(V) + 1
    gamma = gk._cprod_split_operands(torch.as_tensor(Vm), c, inv, 3)[3][0]
    assert (gamma > 1).all()
    B = gk.cprod_split_plain(P, n, torch.as_tensor(Vm), c, inv,
                             terms=3).numpy()
    close(B, jop.cprod(Vm), JAX_TOL)
    close(B, dense_f32(packed, n, c, inv).T @ Vm.astype(np.float64), 1e-5)
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


def dense_f32(packed, n, c, inv):
    """float64 oracle (n, m) of the operator's own f32 center and inv
    tensors, NA -> 0: the function the port computes (`dense` takes the
    float64 center and scale, which differ from those by their f32
    rounding)."""
    X = junpack.np_unpack_codes(packed, n).astype(int)
    d = np.where(X == 1, np.nan, 2 - ((X + 1) >> 1)).T.astype(float)
    return np.nan_to_num((d - c.double().numpy()) * inv.double().numpy(),
                         nan=0.0)


def gwas_operand(rng, n, covariates):
    """big_univLinReg's cprod operand [yr | Q] (`assoc/gwas.py`): Q from the
    QR of [1 | covariates], yr the phenotype's residual, in float32."""
    Q, _ = np.linalg.qr(np.column_stack([np.ones(n),
                                         rng.standard_normal((n, covariates))]))
    y = rng.standard_normal(n)
    return np.column_stack([y - Q @ (Q.T @ y), Q]).astype(np.float32)


@pytest.mark.parametrize("kind", ["|N|+1", "ones", "-|N|-1", "[yr | Q]"])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_three_term_cprod_holds_operands_of_nonzero_mean(kind, na_prob):
    """K1's algebra (`cprod_split_plain(terms=3)`) on operands whose
    columns do not average zero, at 40,003 samples: the plane sums grow
    like n and the result like sqrt(n) (the uncentred algebra misses
    float64 by 2.2e-4 of max |ref| on |N|+1 here, the direct f32 twin by
    7.6e-6). Centred, it is within 1e-5 of max |ref| of JAX's interpret
    HIGHEST cprod and of float64 (of the operator's f32 center and inv);
    on V = 1, whose exact product is near 0, its max abs error is at most
    4x the direct twin's. The GWAS operand [yr | 1 | 10 covariates] runs
    on big_univLinReg's operator (the variant means, scale 1).
    Monomorphic and scale-0 variants; NA and NA-free packs."""
    n, m = 40_003, 203
    jp = bt.snp_fake(n, m, seed=13, na_prob=na_prob)
    packed = np.asarray(jp.packed).copy()
    packed[5] = 0                                    # monomorphic
    jp = bt.GenoPack(packed=packed, n=n)
    sc = bt.bed_scaleBinom(jp)
    rng = np.random.default_rng(5)
    if kind == "[yr | Q]":
        scale = np.ones(m)
        V = gwas_operand(rng, n, 10)
    else:
        scale = scale_with_zeros(sc)
        V = {"|N|+1": np.abs(rng.standard_normal((n, 12))) + 1,
             "ones": np.ones((n, 1)),
             "-|N|-1": -np.abs(rng.standard_normal((n, 12))) - 1}[kind]
        V = V.astype(np.float32)
    jop = pk.PallasOperator(jp, sc["center"], scale, interpret=True,
                            mxu="highest")
    pop = pt.GenoOperator(interop.pack_from_numpy(packed, n), sc["center"],
                          scale)
    P, c, inv = pop.packed, pop.center, pop.inv
    Vt = torch.as_tensor(V)
    gamma = gk._cprod_split_operands(Vt, c, inv, 3)[3][0]
    # the centring is on: every column, or the GWAS operand's intercept
    assert (gamma[1 if kind == "[yr | Q]" else slice(None)] != 0).all()
    B = gk.cprod_split_plain(P, n, Vt, c, inv, terms=3).numpy()
    ref64 = dense_f32(packed, n, c, inv).T @ V.astype(np.float64)
    if kind == "ones":
        twin = gk.cprod_plain(P, n, Vt, c, inv).numpy()
        assert (np.abs(B - ref64).max()
                <= 4 * np.abs(twin - ref64).max())
    else:
        close(B, jop.cprod(V), JAX_TOL)
        close(B, ref64, 1e-5)
    if kind != "[yr | Q]":
        assert np.all(B[::17] == 0.0)


# ---------------------------------------------------------------------------
# K1's operand preparation (`geno_plane_prep`, cprod, three terms) emulated
# as `csrc/geno_split.cu` writes it
# ---------------------------------------------------------------------------

def sigma64(kk):
    """The depth order of cprod's operand within 64 samples."""
    return (16 * ((kk & 7) >> 1) + 4 * (kk >> 4) + 2 * ((kk >> 3) & 1)
            + (kk & 1))


def bf16(x):
    """float32 -> bf16 round to nearest even, as float32."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def emulate_k1_prep(V, plan):
    """`geno_plane_prep(prod=0, terms=3)` in numpy: plane_partial_kernel's
    float64 sums of each 64 samples (V, |V|, |V|, 1), plane_sum_kernel's
    order (thread t adds blocks t, t + 256, ... in order, then a tree over
    the 256 threads), gamma = the mean rounded to bf16 or 0, then
    plane_write_kernel: per column tile of bn rows, bn - 1 of V's columns
    minus gamma and the count row of ones, each split into three bf16
    terms in f32, written in the sigma64 depth order, zeros past l and
    past n. Returns (Bop (3, l_pad, ldk) f32, sumv (l,) f64, gamma (l,)
    f32)."""
    n, l = V.shape
    ldk = -(-n // 64) * 64
    blocks = ldk // 64
    bn, l_pad = plan["bn"], plan["l_pad"]
    q = np.zeros((4, l, blocks))
    for b in range(blocks):
        for d in range(64 * b, min(n, 64 * b + 64)):
            x = V[d].astype(np.float64)
            q[0, :, b] += x
            q[1, :, b] += np.abs(x)
            q[2, :, b] += np.abs(x)
            q[3, :, b] += 1.0
    red = np.zeros((4, l, 256))
    for t in range(256):
        for b in range(t, blocks, 256):
            red[:, :, t] += q[:, :, b]
    h = 128
    while h:
        red[:, :, :h] = red[:, :, :h] + red[:, :, h:2 * h]
        h //= 2
    tot = red[:, :, 0]
    sumv = tot[0]
    a0 = np.where(tot[3] > 0, tot[0] / np.where(tot[3] > 0, tot[3], 1), 0.0)
    keep = np.abs(a0) * 1024.0 * n >= tot[1]
    gamma = np.where(keep, bf16(a0.astype(np.float32)), 0.0).astype(np.float32)
    Bop = np.zeros((3, l_pad, ldk), np.float32)
    perm = np.array([sigma64(kk) for kk in range(64)])
    for r in range(l_pad):
        count = r % bn == bn - 1
        col = (r // bn) * (bn - 1) + r % bn
        x = np.zeros(ldk, np.float32)
        if count:
            x[:n] = 1.0
        elif col < l:
            x[:n] = V[:, col] - gamma[col]
        x = x.reshape(-1, 64)[:, perm].reshape(-1)
        for t in range(3):
            b = bf16(x)
            Bop[t, r] = b
            x = (x - b).astype(np.float32)
    return Bop, sumv, gamma


@pytest.mark.parametrize("n,l", [(1001, 1), (1003, 12), (130, 20),
                                 (4099, 31), (200, 45)])
def test_k1_prep_emulation_equals_the_twin_operand(n, l):
    """The operand the C side writes for K1, emulated (`emulate_k1_prep`),
    is the twin's (`_cprod_split_operands(terms=3)`) once its tiles and
    depth order are undone: gamma bit-equal, every term bit-equal, the
    count row 1 on the n samples and 0 in the lower terms, zeros past l
    and past n; the float64 sums to round-off. Columns of mean far from
    zero, near zero (gamma 0) and of a tiny constant."""
    rng = np.random.default_rng(n + l)
    V = rng.standard_normal((n, l)).astype(np.float32)
    cols = np.arange(l)
    far = (cols % 3 == 0) & (cols < l - 1)
    near = (cols % 3 == 1) & (cols < l - 1)
    V[:, far] = np.abs(V[:, far]) + 1
    V[:, near] -= V[:, near].mean(0)
    V[:, -1] = 1e-3
    plan = gk.plane_plan(False, 3, 777, n, l, 132)
    Bop, sumv, gamma = emulate_k1_prep(V, plan)
    qs, qsum, A, shift = gk._cprod_split_operands(
        torch.as_tensor(V), torch.ones(777), torch.ones(777), 3)
    np.testing.assert_array_equal(gamma, shift[0].numpy())
    assert torch.equal(shift[0], shift[1])
    assert (gamma[near] == 0).all() and (gamma[far] > 1).all()
    assert gamma[-1] == bf16(1e-3)
    np.testing.assert_allclose(sumv, qsum.numpy(), rtol=1e-12, atol=1e-9)
    ldk = Bop.shape[-1]
    inv_perm = np.argsort([sigma64(kk) for kk in range(64)])
    true = Bop.reshape(3, -1, ldk // 64, 64)[..., inv_perm].reshape(3, -1, ldk)
    bn, cols = plan["bn"], plan["cols"]
    rows = np.array([(c // cols) * bn + c % cols for c in range(l)])
    qs = qs.to(torch.float32).numpy()
    for t in range(3):
        np.testing.assert_array_equal(true[t, rows, :n], qs[t * l:(t + 1) * l])
    counts = np.arange(bn - 1, plan["l_pad"], bn)
    np.testing.assert_array_equal(true[0, counts, :n],
                                  np.broadcast_to(qs[3 * l], (len(counts), n)))
    assert (true[1:, counts] == 0).all()
    assert (true[:, :, n:] == 0).all()
    live = np.zeros(plan["l_pad"], bool)
    live[rows] = True
    live[counts] = True
    assert (true[:, ~live] == 0).all()


# ---------------------------------------------------------------------------
# the launch plan of the K1 / K2 / K7 GEMM (`plane_plan`), at the card
# tests' shapes and the chip's
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
            or plan["cols"] != bn - (1 if terms == 3 else 0)
            or ks not in (1, 2, 4) or not 2 <= plan["stages"] <= 8
            or plan["kps"] < 1
            or -(-ktiles // plan["kps"]) != plan["splits"]
            or plan["grid"] < 1 or smem > PLANE_SMEM
            or smem != plan["smem"]
            or (terms == 3 and plan["kps"] * 64 * ks > 2 ** 23))


@pytest.mark.parametrize("l", [1, 12, 20, 50, 120, 650])
@pytest.mark.parametrize("n", [1001, 1009, 4099, 15_000, 20_000, 50_000])
@pytest.mark.parametrize("prod,terms", [(False, 2), (True, 2), (True, 3),
                                        (False, 3)])
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
    """The plans the chip's shapes get: l <= 31 (K1, K2, whose tile of 32
    ends in its count column) or 40 (K7) is one column tile (the pack
    decoded once an item); slice 1's 50,000-sample prod and its
    100,000-variant cprod (the power step's l = 20, the GWAS's 12) fill
    the card unsplit; the GWAS of slices 2 and 5 (15,000 training
    samples, [yr | 1]) is one tile of 8; the grid PRS's l = 650 takes 21
    tiles of 32 (31 columns each) under K2."""
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
    for l, bn in ((20, 24), (12, 16)):
        p = gk.plane_plan(False, 3, 100_000, 50_000, l, 132)
        assert (p["bn"], p["cols"], p["n_tiles"], p["splits"]) == (bn, bn - 1,
                                                                   1, 1)
        assert p["ksub"] == 4 and p["stages"] >= 2
        assert not plane_refused(p, False, 3, 100_000, 50_000, l)
    p = gk.plane_plan(False, 3, 100_000, 15_000, 2, 132)
    assert (p["bn"], p["n_tiles"], p["splits"]) == (8, 1, 1)
    for terms, widest in ((2, 40), (3, 31)):
        for l in range(1, widest + 1):
            for prod in (True, False):
                assert gk.plane_plan(prod, terms, 100_000, 20_000, l,
                                     132)["n_tiles"] == 1



# ---------------------------------------------------------------------------
# depths past 2^23: three terms split the depth into runs of at most 2^23
# (the count column's f32 sums stay exact in a run) and add the runs'
# counts in float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [2 ** 23 + 1, 2 ** 24 + 3])
@pytest.mark.parametrize("prod", [True, False])
@pytest.mark.parametrize("l,M", [(20, 64), (1, 20_000), (650, 64)])
def test_plane_plan_splits_a_depth_past_2_23(K, prod, l, M):
    """K2 (prod, depth = variants) and K1 (cprod, depth = samples) at a
    depth past 2^23: every run is at most 2^23 deep, the C side's checks
    (with the per-run limit) pass, and the runs cover the depth once a
    tile; K7 (two terms) keeps its plan; an explicit splits=1 raises."""
    from test_torch_geno_i8 import walk

    m, n = (K, M) if prod else (M, K)
    plan = gk.plane_plan(prod, 3, m, n, l, 132)
    ksub = plan["ksub"]
    assert plan["kps"] * 64 * ksub <= gk.MAX_COUNT_DEPTH == 2 ** 23
    assert plan["splits"] >= -(-K // 2 ** 23)
    assert plan["splits"] * plan["kps"] * 64 * ksub >= K
    assert not plane_refused(plan, prod, 3, m, n, l)
    seen = walk(plan, M, K)
    for tile in {(mt, t) for mt, t, _, _ in seen}:
        runs = sorted((k0, k1) for mt, t, k0, k1 in seen if (mt, t) == tile)
        assert runs[0][0] == 0 and runs[-1][1] == plan["ktiles"]
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    with pytest.raises(ValueError, match=r"2\^23"):
        gk.plane_plan(prod, 3, m, n, l, 132, splits=1)
    two = gk.plane_plan(prod, 2, m, n, l, 132, splits=1)
    assert two["splits"] == 1 and not plane_refused(two, prod, 2, m, n, l)


def test_split_epilogue_adds_counts_past_2_24_in_float64():
    """The three-term epilogue on synthetic raw sums of three runs whose
    counts T, N are odd integers just below 2^24 each: their totals pass
    2^24, where float32 has no odd integers. Summed in float64 (the twin,
    as `geno_plane_epilogue` does) the result is exact; in float32 it is
    not."""
    S, R, l, terms = 3, 4, 2, 3
    raw = torch.zeros((S, 2, R, terms * l + 1), dtype=torch.float32)
    t = [2 ** 24 - 1, 2 ** 24 - 3, 2 ** 24 - 5]
    step = np.arange(R)
    for r in range(S):
        raw[r, 0, :, -1] = torch.as_tensor(t[r] - 2 * step)
        raw[r, 1, :, -1] = torch.as_tensor(t[S - 1 - r] - 4 * step)
    T = sum(t) - 6 * step
    N = sum(t) - 12 * step
    alpha = torch.tensor([1.0, 0.5])
    beta = torch.tensor([0.25, 2.0])
    small = torch.tensor([0.125, -0.375], dtype=torch.float64)
    for i in range(R):     # sumv is per column: one row at a time
        sv = alpha.double() * int(T[i]) + beta.double() * int(N[i]) + small
        out = gk._split_epilogue_plain(raw[:, :, i:i + 1], l, sv,
                                       terms=terms, shift=(alpha, beta))
        assert torch.equal(out[0], small.float())
    # the same counts summed in float32, the old order: not exact
    assert sum(t) > 2 ** 24 and sum(t) % 2 == 1
    assert (raw[:, 0, :, -1].sum(0).double().numpy() != T).all()
    assert (raw[:, 1, :, -1].sum(0).double().numpy() != N).all()


@pytest.mark.parametrize("prod", [True, False])
def test_three_term_twin_runs_equal_one_run(prod):
    """`_split_raw_plain` over depth runs (here of 100 and 64, where the
    twin takes 2^23): the runs' raw sums add up to the one-run sums, and
    the epilogue over the runs equals the one-run result to f32
    round-off."""
    pp = bt.snp_fake(301, 523, seed=5, na_prob=0.05)
    packed = torch.as_tensor(np.asarray(pp.packed))
    rng = np.random.default_rng(5)
    c = torch.as_tensor(rng.uniform(0, 2, 523), dtype=torch.float32)
    inv = torch.as_tensor(rng.uniform(0, 3, 523), dtype=torch.float32)
    n, l = 301, 7
    if prod:
        U = torch.as_tensor(np.abs(rng.standard_normal((523, l))) + 1,
                            dtype=torch.float32)
        zbs, zas, sumv, shift = gk._prod_split_operands(U, c, inv, 3)
        ops, kw = [zbs, zas], {}
    else:
        V = torch.as_tensor(np.abs(rng.standard_normal((n, l))) + 1,
                            dtype=torch.float32)
        qs, sumv, A, shift = gk._cprod_split_operands(V, c, inv, 3)
        ops, kw = [qs], {"A": A, "s": inv}
    one = gk._split_raw_plain(packed, n, ops, prod)
    ref = gk._split_epilogue_plain(one, l, sumv, terms=3, shift=shift, **kw)
    for run in (100, 64):
        raw = gk._split_raw_plain(packed, n, ops, prod, run=run)
        K = 523 if prod else n
        assert raw.shape[0] == -(-K // run)
        assert torch.equal(raw[:, :, :, -1].sum(0), one[0, :, :, -1])
        out = gk._split_epilogue_plain(raw, l, sumv, terms=3, shift=shift,
                                       **kw)
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
