"""The CUDA kernels (K1, K2 and K7 on bf16 bit planes, K6 on int8 bit planes, K8 on materialized int8 planes, the Gibbs sweep and its
lassosum mode on blocked bands and on one band over every variant)
against their plain-torch twins on a card.

Imports only torch and the port, so it runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Without a CUDA device every test here skips. Tolerance: max |kernel -
twin| <= 1e-4 * max |twin| (float32 sums in two orders)."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.ops import geno_kernels as gk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def dense64(packed, n, c, inv):
    """The float64 standardized matrix (m, n) of a pack on the card."""
    from bigsnpr_tpu_torch.core.unpack import unpack_dosage

    d, na = unpack_dosage(packed, n, dtype=torch.float64)
    return torch.where(na, 0.0, (d - c.double()[:, None])
                       * inv.double()[:, None])


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", [(1001, 777, 1), (1002, 1500, 12),
                                   (1003, 3001, 20), (4097, 513, 50),
                                   (2003, 1500, 650)])
def test_kernels_match_twins(cuda, n, m, l):
    """K1 and K2 against their twins (1e-4 of max |twin|); both (the
    three-term bit-plane kernels) and their twins also within 1e-5 of max
    |float64 product|."""
    pp = pt.snp_fake(n, m, seed=l, na_prob=0.05)
    packed = pp.device_packed(cuda)
    rng = np.random.default_rng(l)
    c = torch.as_tensor(rng.uniform(0, 2, m), dtype=torch.float32, device=cuda)
    inv = torch.as_tensor(rng.uniform(0, 3, m), dtype=torch.float32,
                          device=cuda)
    inv[::11] = 0
    V = torch.randn(n, l, device=cuda)
    U = torch.randn(m, l, device=cuda)
    before = dict(gk.launches)
    X = dense64(packed, n, c, inv)
    for kern, plain, W, ref64 in ((gk.cprod, gk.cprod_plain, V,
                                   X @ V.double()),
                                  (gk.prod, gk.prod_plain, U,
                                   X.T @ U.double())):
        out, ref = kern(packed, n, W, c, inv), plain(packed, n, W, c, inv)
        torch.cuda.synchronize()
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
        for y in (out, ref):
            assert ((y.double() - ref64).abs().max()
                    <= 1e-5 * ref64.abs().max())
    assert gk.launches["cprod"] == before["cprod"] + 1
    assert gk.launches["prod"] == before["prod"] + 1


@pytest.mark.cuda
def test_operator_on_card_matches_cpu(cuda):
    pp = pt.snp_fake(533, 700, seed=3, na_prob=0.05)
    sc = pt.bed_scaleBinom(pp, device="cpu")
    rows = np.arange(0, 533, 2)
    cols = np.arange(0, 700, 3)
    ops = [pt.GenoOperator(pp, sc["center"], sc["scale"], ind_row=rows,
                           ind_col=cols, device=d) for d in ("cpu", cuda)]
    V = np.random.default_rng(0).standard_normal((len(rows), 20))
    (B0, Y0), (B1, Y1) = (op.power(V) for op in ops)
    assert np.abs(B1 - B0).max() <= 1e-4 * np.abs(B0).max()
    assert np.abs(Y1 - Y0).max() <= 1e-4 * np.abs(Y0).max()


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda):
    """No float atomics: the split reduction runs in a fixed order."""
    pp = pt.snp_fake(5000, 3000, seed=1, na_prob=0.01)
    packed = pp.device_packed(cuda)
    c = torch.ones(3000, device=cuda)
    inv = torch.ones(3000, device=cuda)
    V = torch.randn(5000, 20, device=cuda)
    U = torch.randn(3000, 20, device=cuda)
    assert torch.equal(gk.cprod(packed, 5000, V, c, inv),
                       gk.cprod(packed, 5000, V, c, inv))
    assert torch.equal(gk.prod(packed, 5000, U, c, inv),
                       gk.prod(packed, 5000, U, c, inv))


# K6 / K8 shapes: l = 1, 12, 20, 21 and 65 (N = 260: three column tiles);
# n = 1001 (nb = 251 bytes, rows not 4-byte aligned) and 1009 (not a
# multiple of 16); M from fewer 128-row tiles than SMs to more than the
# persistent grid holds (20,000 variants: 157 cprod tiles; 20,011
# samples: 157 prod tiles)
I8_SHAPES = [(1000, 777, 1), (1001, 1500, 12), (1002, 3001, 20),
             (4099, 513, 21), (1001, 700, 65), (1009, 1500, 20),
             (20_011, 20_000, 12)]


def i8_case(n, m, l, seed, na_prob):
    """A pack on the card with NA (or none), monomorphic and scale-0
    variants, and center / inv / operands for K6."""
    pp = pt.snp_fake(n, m, seed=seed, na_prob=na_prob)
    packed = pp.device_packed("cuda").clone()
    packed[::13] = 0                                   # monomorphic: all 2
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    inv = rng.uniform(0.5, 3, m)
    inv[::7] = 0.0
    c = np.where(inv > 0, rng.uniform(0, 2, m), 2.0)
    return (packed, f(c), f(inv), f(rng.standard_normal((n, l))),
            f(rng.standard_normal((m, l))))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", I8_SHAPES)
@pytest.mark.parametrize("nona", [False, True])
def test_i8_kernels_match_twins(cuda, n, m, l, nona):
    """K6 in its four instantiations against the twin: the raw int32 digit
    sums equal, the float32 outputs within 1e-6 of max |twin| (the
    epilogue is built with --fmad=false); two launches bit-equal."""
    packed, c, inv, V, U = i8_case(n, m, l, l, 0.0 if nona else 0.05)
    for kern, plain, W, key in ((gk.cprod_i8, gk.cprod_i8_plain, V,
                                 "cprod_i8"),
                                (gk.prod_i8, gk.prod_i8_plain, U, "prod_i8")):
        key += "_nona" if nona else ""
        before = gk.launches[key]
        out, raw = kern(packed, n, W, c, inv, nona=nona, return_raw=True)
        again = kern(packed, n, W, c, inv, nona=nona)
        ref, raw_ref = plain(packed, n, W, c, inv, nona=nona,
                             return_raw=True)
        torch.cuda.synchronize()
        assert gk.launches[key] == before + 2
        assert torch.equal(raw, raw_ref)
        assert torch.equal(out, again)
        assert (out - ref).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("nona", [False, True])
def test_i8_sums_do_not_depend_on_depth_splits(cuda, nona):
    """Integer sums are exact: the raw sums and outputs are the same with
    the depth unsplit, split any of 2-16 ways (int32 atomics; more splits
    than depth tiles fold to one a tile) and planned."""
    packed, c, inv, V, U = i8_case(2049, 1537, 20, 7, 0.0 if nona else 0.05)
    for kern, W in ((gk.cprod_i8, V), (gk.prod_i8, U)):
        ref = kern(packed, 2049, W, c, inv, nona, True)
        for s in range(1, 17):
            got = kern(packed, 2049, W, c, inv, nona, True, s)
            assert torch.equal(got[1], ref[1])
            assert torch.equal(got[0], ref[0])


@pytest.mark.cuda
def test_i8_operator_masks_and_detects_nona(cuda):
    """The int8 operator with ind_row / ind_col on the card against the
    float32 one, and the NA-free scan: one NA code turns nona off."""
    pp = pt.snp_fake(533, 700, seed=5, na_prob=0.0)
    sc = pt.bed_scaleBinom(pp, device="cpu")
    rows, cols = np.arange(0, 533, 2), np.arange(0, 700, 3)
    ops = [pt.GenoOperator(pp, sc["center"], sc["scale"], ind_row=rows,
                           ind_col=cols, device=cuda, mxu=mxu)
           for mxu in ("highest", "int8")]
    assert ops[1].nona
    V = np.random.default_rng(0).standard_normal((len(rows), 20))
    (B0, Y0), (B1, Y1) = (op.power(V) for op in ops)
    assert np.abs(B1 - B0).max() <= 2e-5 * np.abs(B0).max()
    assert np.abs(Y1 - Y0).max() <= 2e-5 * np.abs(Y0).max()
    packed = pp.packed.copy()
    packed[3, 5] = (packed[3, 5] & 0b11111100) | 0b01     # one NA code
    one = pt.GenoPack(packed=packed, n=533)
    assert not pt.GenoOperator(one, sc["center"], sc["scale"], device=cuda,
                               mxu="int8").nona


@pytest.mark.cuda
def test_i8_guard_refuses_int32_overflow(cuda):
    """A raw sum is at most 254 x the contraction length: past 8,000,000
    samples the wrapper raises before any launch."""
    n = 8_000_004
    packed = torch.zeros((1, n // 4), dtype=torch.uint8, device=cuda)
    c, inv = torch.ones(1, device=cuda), torch.ones(1, device=cuda)
    before = dict(gk.launches)
    with pytest.raises(ValueError, match="overflow"):
        gk.cprod_i8(packed, n, torch.ones((n, 1), device=cuda), c, inv)
    assert gk.launches == before


def sweep_case(sizes, NC, seed, dtype=torch.float32, width=None):
    """Block-diagonal AR-like LD (band width capped at `width`), bands on
    the card, and one sweep's state and pre-drawn u / z."""
    import scipy.sparse as sp

    from bigsnpr_tpu_torch import interop
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as pgb

    rng = np.random.default_rng(seed)
    mats = []
    for sz in sizes:
        A = rng.normal(size=(sz, 4 * sz))
        C = np.corrcoef(0.6 * A + 0.4 * np.roll(A, 1, axis=0))
        if width is not None:
            C = np.triu(np.tril(C, width), -width)
        mats.append(sp.coo_matrix(C))          # no stored zeros
    up = sp.triu(sp.block_diag(mats).tocsc()).tocsc()
    corr = interop.sparse_ld_from_numpy(up.data, up.indices, up.indptr,
                                        up.shape)
    bb = pgb.build_block_bands(corr, sizes)
    m = bb.m
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    st = dict(bh=f(rng.normal(0, 0.05, m)),
              C2=f(rng.uniform(0.1, 0.9, (NC, m))),
              C4=f(rng.uniform(0.1, 0.9, (NC, m))),
              s1=f(rng.uniform(1.0, 2.0, (NC, m))),
              u=f(rng.uniform(0, 1, (NC, m))), z=f(rng.normal(0, 1, (NC, m))),
              cb=f(rng.normal(0, 0.05, (NC, m))
                   * (rng.random((NC, m)) < 0.5)),
              inv_odd_p=f(rng.uniform(1, 9, NC)), p=f(rng.uniform(0.05, 0.4, NC)),
              sparse=torch.as_tensor(np.arange(NC) % 2 == 1, device="cuda"))
    sb = bb.device_put("cuda", dtype=np.float64 if dtype == torch.float64
                       else np.float32)
    st["dp"] = f(rng.normal(0, 0.05, (NC, sb.dp_len)))
    return sb, st


def plan_at(sb, NC, nct, lasso=False):
    """Plan the sweep (the lassosum mode with `lasso`) for NC chains at nct
    chains a CTA (the plan's ring, its stages where they still fit)."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    smem = gsk.max_smem("cuda")
    pl = gsk.plan(sb, NC, smem, lasso)
    elem = sb.band.element_size()
    stage = pl.stage if gsk.ring_smem_bytes(nct, pl.ring_len, elem,
                                            pl.stage) <= smem else 0
    sb.plans[gsk.plan_key(NC, lasso)] = gsk.SweepPlan(
        nct, gsk.ring_threads(nct), pl.ring_len, stage,
        gsk.ring_smem_bytes(nct, pl.ring_len, elem, stage))


def run_sweep(fn, sb, st, shrink, no_jump):
    dp = st["dp"].clone()
    out = fn(sb, dp, st["cb"], st["bh"], st["C2"], st["C4"], st["s1"],
             st["u"], st["z"], st["inv_odd_p"], st["p"], st["sparse"],
             shrink, no_jump)
    torch.cuda.synchronize()
    return (dp,) + tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,NC,dtype,shrink,no_jump", [
    ([300, 41, 7], 1, torch.float32, 1.0, False),           # K3: one chain
    ([20] * 12 + [9], 4, torch.float32, 0.95, True),        # K4: narrow
    ([1000, 700, 130], 30, torch.float32, 1.0, False),      # K5: 30 chains
    ([257, 60], 5, torch.float64, 0.9, True)])
def test_sweep_matches_twin(cuda, sizes, NC, dtype, shrink, no_jump):
    """The CUDA sweep against its twin on the card: same pre-drawn u / z,
    ragged blocks with pad slots, sparse and no-jump-sign chains. Built
    with --fmad=false, the kernel rounds as the twin's separate torch
    operations do: tolerance 1e-5 of max |twin|, causal equal."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gk

    sb, st = sweep_case(sizes, NC, 3, dtype, width=16 if NC == 4 else None)
    before = gk.launches["sweep"]
    got = run_sweep(gk.sweep, sb, st, shrink, no_jump)
    assert gk.launches["sweep"] == before + 1
    ref = run_sweep(gk.sweep_plain, sb, st, shrink, no_jump)
    assert torch.equal(got[2], ref[2])                      # causal
    for a, b in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)


@pytest.mark.cuda
def test_sweep_repeats_bit_for_bit(cuda):
    """No float atomics: partial sums per (chain, block), added in order."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gk

    sb, st = sweep_case([500, 300, 64], 6, 4)
    a = run_sweep(gk.sweep, sb, st, 1.0, False)
    b = run_sweep(gk.sweep, sb, st, 1.0, False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_sampler_loop_never_waits_on_the_device(cuda):
    """The LDpred2-auto sweep loop (sweep kernel, draws, hyper-parameter
    and MLE updates) issues no synchronizing call: the count of syncs torch
    reports is the same for 3 sweeps and for 12."""
    import warnings

    from bigsnpr_tpu_torch.pgs import gibbs_blocked as pgb
    from bigsnpr_tpu_torch.pgs.gibbs import chain_generators

    sb, st = sweep_case([300, 200, 64], 4, 5)
    lv = torch.log(st["C4"][0])

    def syncs(sweeps):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                pgb.gibbs_auto_blocked_multi(
                    sb, st["bh"], torch.full_like(st["bh"], 1e4), lv,
                    torch.tensor([0.01, 0.05, 0.1, 0.3], device="cuda"),
                    0.3, chain_generators(1, 4, "cuda"), 0.95, (1e-5, 1.0),
                    np.array([-0.5, 1.5]), 3.0, sweeps - 1, 1,
                    no_jump_sign=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(x.message) for x in w)

    assert syncs(3) == syncs(12)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", [(1000, 777, 1), (1001, 1500, 12),
                                   (1002, 3001, 20), (4099, 513, 21)])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_split_kernels_match_twins(cuda, n, m, l, na_prob):
    """K7 against its twin: within 1e-5 of max |twin| (float32 sums in
    another order), both within 2e-5 of max |float64 product|, two
    launches bit-equal, one count a launch; monomorphic and scale-0
    variants, n = 0..3 (mod 4)."""
    packed, c, inv, V, U = i8_case(n, m, l, l, na_prob)
    X = dense64(packed, n, c, inv)
    for kern, plain, W, ref64, key in (
            (gk.cprod_split, gk.cprod_split_plain, V, X @ V.double(),
             "cprod_split"),
            (gk.prod_split, gk.prod_split_plain, U, X.T @ U.double(),
             "prod_split")):
        before = gk.launches[key]
        out, again = kern(packed, n, W, c, inv), kern(packed, n, W, c, inv)
        ref = plain(packed, n, W, c, inv)
        torch.cuda.synchronize()
        assert gk.launches[key] == before + 2
        assert torch.equal(out, again)
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
        for y in (out, ref):
            assert (y.double() - ref64).abs().max() <= 2e-5 * ref64.abs().max()


@pytest.mark.cuda
def test_split_depth_splits_repeat(cuda):
    """Any depth split (1-16) gives the twin's result within 1e-5 of its
    max (K1, K2: 1e-4 of the direct twin), and each split count repeats
    bit for bit (no float atomics)."""
    packed, c, inv, V, U = i8_case(3001, 2049, 20, 9, 0.05)
    for kern, plain, W, tol in (
            (gk.cprod_split, gk.cprod_split_plain, V, 1e-5),
            (gk.prod_split, gk.prod_split_plain, U, 1e-5),
            (gk.prod, gk.prod_plain, U, 1e-4),
            (gk.cprod, gk.cprod_plain, V, 1e-4)):
        ref = plain(packed, 3001, W, c, inv)
        for sp_ in range(1, 17):
            a = kern(packed, 3001, W, c, inv, splits=sp_)
            b = kern(packed, 3001, W, c, inv, splits=sp_)
            assert torch.equal(a, b)
            assert (a - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", [(1000, 777, 1), (1001, 1500, 12),
                                   (1002, 3001, 20), (1003, 513, 21),
                                   (4099, 2049, 50), (20_011, 2100, 20)])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_k2_planes_match_twins_and_float64(cuda, n, m, l, na_prob):
    """K2 on three-term bit planes at awkward shapes (n = 0..3 mod 4,
    ragged m, monomorphic and scale-0 variants, NA and NA-free packs):
    within 1e-4 of max |direct twin|, within 1e-5 of max |float64| as its
    twin is, within 1e-5 of the plain three-term plane algebra
    (`prod_split_plain(terms=3)`: f32 sums in another order); two launches
    bit-equal, one count a launch."""
    packed, c, inv, V, U = i8_case(n, m, l, l + 1, na_prob)
    ref64 = dense64(packed, n, c, inv).T @ U.double()
    before = gk.launches["prod"]
    out, again = gk.prod(packed, n, U, c, inv), gk.prod(packed, n, U, c, inv)
    ref = gk.prod_plain(packed, n, U, c, inv)
    alg = gk.prod_split_plain(packed, n, U, c, inv, terms=3)
    torch.cuda.synchronize()
    assert gk.launches["prod"] == before + 2
    assert torch.equal(out, again)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (out - alg).abs().max() <= 1e-5 * alg.abs().max()
    for y in (out, ref):
        assert (y.double() - ref64).abs().max() <= 1e-5 * ref64.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["|N|+1", "ones", "-|N|-1"])
def test_k2_holds_operands_of_nonzero_mean(cuda, kind):
    """K2 on an operand whose columns do not average zero (all-positive or
    all-negative weights, U = 1), at 100,000 variants of a cohort scaled
    by its own means: the plane sums grow like m and the result like
    sqrt(m), so K2 centres its operand. Within 1e-5 of max |float64| as
    its twin is, 1e-4 of the twin, 1e-5 of the plain three-term algebra;
    unsplit and with the depth split in 7; two launches bit-equal."""
    n, m = 2003, 100_000
    pp = pt.snp_fake(n, m, seed=17, na_prob=0.01)
    sc = pt.bed_scaleBinom(pp, device=cuda)
    op = pt.GenoOperator(pp, sc["center"], sc["scale"], device=cuda)
    packed, c, inv = op.packed, op.center, op.inv
    rng = np.random.default_rng(17)
    U = {"|N|+1": np.abs(rng.standard_normal((m, 20))) + 1,
         "ones": np.ones((m, 1)),
         "-|N|-1": -np.abs(rng.standard_normal((m, 20))) - 1}[kind]
    U = torch.as_tensor(U, dtype=torch.float32, device=cuda)
    ref64 = dense64(packed, n, c, inv).T @ U.double()
    twin = gk.prod_plain(packed, n, U, c, inv)
    alg = gk.prod_split_plain(packed, n, U, c, inv, terms=3)
    assert (twin.double() - ref64).abs().max() <= 1e-5 * ref64.abs().max()
    for splits in (None, 7):
        out = gk.prod(packed, n, U, c, inv, splits=splits)
        again = gk.prod(packed, n, U, c, inv, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert (out - twin).abs().max() <= 1e-4 * twin.abs().max()
        assert (out - alg).abs().max() <= 1e-5 * alg.abs().max()
        assert ((out.double() - ref64).abs().max()
                <= 1e-5 * ref64.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", [(1000, 777, 1), (1001, 1500, 12),
                                   (1002, 3001, 20), (1003, 513, 21),
                                   (4099, 2049, 50), (20_011, 2100, 20)])
@pytest.mark.parametrize("na_prob", [0.05, 0.0])
def test_k1_planes_match_twins_and_float64(cuda, n, m, l, na_prob):
    """K1 on three-term bit planes at awkward shapes (n = 0..3 mod 4,
    ragged m, monomorphic and scale-0 variants, NA and NA-free packs):
    within 1e-4 of max |direct twin|, within 1e-5 of max |float64| as its
    twin is, within 1e-5 of the plain three-term plane algebra
    (`cprod_split_plain(terms=3)`: f32 sums in another order); two
    launches bit-equal, one count a launch."""
    packed, c, inv, V, U = i8_case(n, m, l, l + 2, na_prob)
    ref64 = dense64(packed, n, c, inv) @ V.double()
    before = gk.launches["cprod"]
    out, again = gk.cprod(packed, n, V, c, inv), gk.cprod(packed, n, V, c, inv)
    ref = gk.cprod_plain(packed, n, V, c, inv)
    alg = gk.cprod_split_plain(packed, n, V, c, inv, terms=3)
    torch.cuda.synchronize()
    assert gk.launches["cprod"] == before + 2
    assert torch.equal(out, again)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (out - alg).abs().max() <= 1e-5 * alg.abs().max()
    for y in (out, ref):
        assert (y.double() - ref64).abs().max() <= 1e-5 * ref64.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["|N|+1", "ones", "-|N|-1", "[yr | Q]"])
def test_k1_holds_operands_of_nonzero_mean(cuda, kind):
    """K1 on an operand whose columns do not average zero (all-positive or
    all-negative weights, V = 1, the GWAS operand [yr | 1 | 10 covariates]
    on big_univLinReg's operator: the variant means, scale 1), at 100,003
    samples of a cohort scaled by its own means: the plane sums grow like
    n and the result like sqrt(n), so K1 centres its operand. Within 1e-5
    of max |float64| and of the plain three-term algebra (V = 1, whose
    exact product is near 0: its max abs error at most 4x the direct
    twin's); unsplit and with the depth split in 1, 2, 5 and 16, each
    within 1e-5 of max |unsplit|; two launches bit-equal."""
    n, m = 100_003, 2003
    pp = pt.snp_fake(n, m, seed=19, na_prob=0.01)
    sc = pt.bed_scaleBinom(pp, device=cuda)
    rng = np.random.default_rng(19)
    if kind == "[yr | Q]":
        scale = np.ones(m)
        Q, _ = np.linalg.qr(np.column_stack([np.ones(n),
                                             rng.standard_normal((n, 10))]))
        y = rng.standard_normal(n)
        V = np.column_stack([y - Q @ (Q.T @ y), Q])
    else:
        scale = sc["scale"]
        V = {"|N|+1": np.abs(rng.standard_normal((n, 20))) + 1,
             "ones": np.ones((n, 1)),
             "-|N|-1": -np.abs(rng.standard_normal((n, 20))) - 1}[kind]
    op = pt.GenoOperator(pp, sc["center"], scale, device=cuda)
    packed, c, inv = op.packed, op.center, op.inv
    V = torch.as_tensor(V, dtype=torch.float32, device=cuda)
    ref64 = dense64(packed, n, c, inv) @ V.double()
    twin = gk.cprod_plain(packed, n, V, c, inv)
    alg = gk.cprod_split_plain(packed, n, V, c, inv, terms=3)
    out = gk.cprod(packed, n, V, c, inv)
    again = gk.cprod(packed, n, V, c, inv)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    err = (out.double() - ref64).abs().max()
    if kind == "ones":
        assert err <= 4 * (twin.double() - ref64).abs().max()
        assert (out - alg).abs().max() <= 4 * (twin - alg).abs().max()
    else:
        assert err <= 1e-5 * ref64.abs().max()
        assert (out - alg).abs().max() <= 1e-5 * alg.abs().max()
    for splits in (1, 2, 5, 16):
        got = gk.cprod(packed, n, V, c, inv, splits=splits)
        assert (got - out).abs().max() <= 1e-5 * out.abs().max()


@pytest.mark.cuda
def test_split_operator_masks_like_the_plain_one(cuda):
    pp = pt.snp_fake(533, 700, seed=5, na_prob=0.05)
    sc = pt.bed_scaleBinom(pp, device="cpu")
    rows, cols = np.arange(0, 533, 2), np.arange(0, 700, 3)
    ops = [ctor(pp, sc["center"], sc["scale"], ind_row=rows, ind_col=cols,
                device=cuda, mxu="split2")
           for ctor in (pt.GenoOperator, pt.TorchOperator)]
    V = np.random.default_rng(0).standard_normal((len(rows), 20))
    (B0, Y0), (B1, Y1) = (op.power(V) for op in ops)
    assert np.abs(B1 - B0).max() <= 1e-5 * np.abs(B1).max()
    assert np.abs(Y1 - Y0).max() <= 1e-5 * np.abs(Y1).max()


def lasso_case(sizes, NG, seed, dtype):
    sb, st = sweep_case(sizes, NG, seed, dtype)
    rng = np.random.default_rng(seed + 1)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    m = sb.m
    return sb, dict(dp=st["dp"], beta=f(rng.normal(0, 0.05, (NG, m))
                                         * (rng.random((NG, m)) < 0.5)),
                    bh=st["bh"], pf=f(rng.uniform(0.8, 1.5, m)),
                    lam=f(rng.uniform(0.001, 0.05, NG)),
                    delta=f(rng.uniform(0.001, 1.0, NG)),
                    active=torch.as_tensor(np.arange(NG) % 5 != 3,
                                           device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,NG,dtype", [
    ([300, 41, 7], 3, torch.float32), ([1000, 700, 130], 120, torch.float32),
    ([257, 60], 7, torch.float64)])
def test_lassosum_mode_matches_twin_bit_for_bit(cuda, sizes, NG, dtype):
    """The lassosum mode against its twin on the card, inactive grid
    points included: dp, betas, gap, df and maxshift bit-equal (float32
    multiply-adds fused in both, float64 ones rounded twice in both)."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    sb, st = lasso_case(sizes, NG, 6, dtype)

    def run(fn):
        dp, beta = st["dp"].clone(), st["beta"].clone()
        out = fn(sb, dp, beta, st["bh"], st["pf"], st["lam"], st["delta"],
                 st["active"])
        torch.cuda.synchronize()
        return (dp, beta) + tuple(out)

    before = gsk.launches["lassosum"]
    got, again = run(gsk.lassosum_sweep), run(gsk.lassosum_sweep)
    ref = run(gsk.lassosum_sweep_plain)
    assert gsk.launches["lassosum"] == before + 2
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b) and torch.equal(a, r)
    frozen = ~st["active"]
    assert torch.equal(got[1][frozen], st["beta"][frozen])


@pytest.mark.cuda
def test_lassosum_loop_reads_done_flags_every_few_sweeps(cuda):
    """lassosum_cd_blocked syncs with the host once every 8 sweeps, not
    once a sweep: 64 sweeps cost at most 7 syncs more than 8."""
    import warnings

    from bigsnpr_tpu_torch.pgs import gibbs_blocked as pgb

    sb, st = lasso_case([300, 200, 64], 6, 8, torch.float32)

    def syncs(maxiter):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                pgb.lassosum_cd_blocked(sb, st["bh"], st["pf"], st["lam"],
                                        st["delta"], 1e9, 0.0, maxiter)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(x.message) for x in w)

    assert syncs(64) - syncs(8) <= 7


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", I8_SHAPES)
@pytest.mark.parametrize("nona", [False, True])
def test_i8m_kernels_match_twins_and_k6(cuda, n, m, l, nona):
    """K8 in its four instantiations: the planes built on the card equal to
    the CPU's; the raw int32 digit sums equal to the twin's and to K6's on
    the same pack, the outputs bit-equal to K6's and within 1e-6 of max
    |twin|; two launches bit-equal, one count a launch."""
    packed, c, inv, V, U = i8_case(n, m, l, l, 0.0 if nona else 0.05)
    planes = gk.int8m_planes(packed, n, nona)
    cpu = gk.int8m_planes(packed.cpu(), n, nona)
    for a, b in zip(planes, cpu):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    for kern, plain, k6, W, key in (
            (gk.cprod_i8m, gk.cprod_i8m_plain, gk.cprod_i8, V, "cprod_i8m"),
            (gk.prod_i8m, gk.prod_i8m_plain, gk.prod_i8, U, "prod_i8m")):
        key += "_nona" if nona else ""
        before = gk.launches[key]
        out, raw = kern(planes, n, W, c, inv, return_raw=True)
        again = kern(planes, n, W, c, inv)
        ref, raw_ref = plain(planes, n, W, c, inv, return_raw=True)
        out6, raw6 = k6(packed, n, W, c, inv, nona=nona, return_raw=True)
        torch.cuda.synchronize()
        assert gk.launches[key] == before + 2
        assert torch.equal(raw, raw_ref) and torch.equal(raw, raw6)
        assert torch.equal(out, again) and torch.equal(out, out6)
        assert (out - ref).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("nona", [False, True])
def test_i8m_sums_do_not_depend_on_depth_splits(cuda, nona):
    packed, c, inv, V, U = i8_case(2049, 1537, 20, 7, 0.0 if nona else 0.05)
    planes = gk.int8m_planes(packed, 2049, nona)
    for kern, W in ((gk.cprod_i8m, V), (gk.prod_i8m, U)):
        ref = kern(planes, 2049, W, c, inv, True)
        for s in range(1, 17):
            got = kern(planes, 2049, W, c, inv, True, s)
            assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])


@pytest.mark.cuda
def test_i8m_operator_equals_the_int8_one(cuda):
    """The masked int8m operator on the card: its power step bit-equal to
    the int8 operator's (same integer sums) and within 1e-6 of the plain
    operator's; only K8 launches."""
    pp = pt.snp_fake(533, 700, seed=9, na_prob=0.05)
    sc = pt.bed_scaleBinom(pp, device="cpu")
    rows, cols = np.arange(0, 533, 2), np.arange(0, 700, 3)
    ops = [ctor(pp, sc["center"], sc["scale"], ind_row=rows, ind_col=cols,
                device=cuda, mxu=mxu)
           for ctor, mxu in ((pt.GenoOperator, "int8m"),
                             (pt.GenoOperator, "int8"),
                             (pt.TorchOperator, "int8m"))]
    V = np.random.default_rng(0).standard_normal((len(rows), 20))
    gk.reset_launches()
    B, Y = ops[0].power(V)
    assert gk.launches["cprod_i8m"] == gk.launches["prod_i8m"] == 1
    assert sum(gk.launches.values()) == 2
    (B8, Y8), (Br, Yr) = ops[1].power(V), ops[2].power(V)
    np.testing.assert_array_equal(B, B8)
    np.testing.assert_array_equal(Y, Y8)
    assert np.abs(B - Br).max() <= 1e-6 * np.abs(Br).max()
    assert np.abs(Y - Yr).max() <= 1e-6 * np.abs(Yr).max()


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,NC,dtype,shrink,no_jump", [
    ([300, 41, 7], 1, torch.float32, 1.0, False),
    ([1000, 700, 130], 30, torch.float32, 0.95, True),
    ([257, 60], 5, torch.float64, 0.9, True)])
def test_global_dp_sweep_matches_twin_and_shared_mode(cuda, sizes, NC, dtype,
                                                      shrink, no_jump):
    """The sweep on small ragged blocks at the plan's chains a CTA and at
    one chain a CTA (the grouping the one-band launches take): against the
    twin (1e-5 of max |twin|, causal equal), the two groupings bit-equal
    (the same operations in the same order; only which CTA runs a chain
    differs), two launches bit-equal, counted as blocked launches."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    sb, st = sweep_case(sizes, NC, 3, dtype)
    before = gsk.launches["sweep"]
    got = run_sweep(gsk.sweep, sb, st, shrink, no_jump)
    again = run_sweep(gsk.sweep, sb, st, shrink, no_jump)
    plan_at(sb, NC, 1)
    one = run_sweep(gsk.sweep, sb, st, shrink, no_jump)
    assert gsk.launches["sweep"] == before + 3
    ref = run_sweep(gsk.sweep_plain, sb, st, shrink, no_jump)
    assert torch.equal(got[2], ref[2])
    for a, b in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got, again, one))


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,NG,dtype", [
    ([300, 41, 7], 3, torch.float32), ([1000, 700, 130], 120, torch.float32),
    ([257, 60], 7, torch.float64)])
def test_global_dp_lassosum_mode_matches_twin_bit_for_bit(cuda, sizes, NG,
                                                          dtype):
    """The lassosum mode at one grid point a CTA: bit-equal to its twin
    and to the plan's grouping, inactive grid points included."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    sb, st = lasso_case(sizes, NG, 6, dtype)

    def run(fn):
        dp, beta = st["dp"].clone(), st["beta"].clone()
        out = fn(sb, dp, beta, st["bh"], st["pf"], st["lam"], st["delta"],
                 st["active"])
        torch.cuda.synchronize()
        return (dp, beta) + tuple(out)

    planned = run(gsk.lassosum_sweep)
    plan_at(sb, NG, 1, lasso=True)
    before = gsk.launches["lassosum"]
    got, again = run(gsk.lassosum_sweep), run(gsk.lassosum_sweep)
    ref = run(gsk.lassosum_sweep_plain)
    assert gsk.launches["lassosum"] == before + 2
    for a, b, r, q in zip(got, again, ref, planned):
        assert torch.equal(a, b) and torch.equal(a, r) and torch.equal(a, q)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,NC,dtype,width", [
    ([2926, 1400, 700, 204, 90, 31], 30, torch.float32, 511),
    ([1500, 300, 120, 77] * 3, 9, torch.float32, 255),
    ([900, 400, 33, 5], 12, torch.float64, None)])
def test_blocked_sweep_at_several_chains_a_cta(cuda, sizes, NC, dtype, width):
    """Ragged blocks (up to slice 2's longest and widest, some shorter than
    a tile, pad slots in their buckets; the band in place at slice 2's
    width and in float64, through stages at slice 4's) at the most chains
    a CTA (RING_MAX_CHAINS), the
    blocks longest first: the sweep against its twin (1e-5, causal equal)
    and at one chain a CTA bit-equal; the lassosum mode, one grid point in
    five frozen, bit-equal to its twin at its most (RING_NARROW) and at
    one point a CTA."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    sb, st = sweep_case(sizes, NC, 21, dtype, width=width)
    rows = sb.blk_rows.cpu().numpy()
    assert (np.diff(rows[sb.order]) <= 0).all()
    nct = min(NC, gsk.RING_MAX_CHAINS)
    plan_at(sb, NC, nct)
    got = run_sweep(gsk.sweep, sb, st, 0.95, True)
    ref = run_sweep(gsk.sweep_plain, sb, st, 0.95, True)
    assert torch.equal(got[2], ref[2])
    for a, b in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)
    plan_at(sb, NC, 1)
    one = run_sweep(gsk.sweep, sb, st, 0.95, True)
    assert all(torch.equal(a, b) for a, b in zip(got, one))
    rng = np.random.default_rng(22)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    m = sb.m
    pf = f(rng.uniform(0.8, 1.5, m))
    lam, delta = f(rng.uniform(0.001, 0.05, NC)), f(rng.uniform(0.01, 1, NC))
    active = torch.as_tensor(np.arange(NC) % 5 != 3, device="cuda")
    beta0 = f(rng.normal(0, 0.05, (NC, m)) * (rng.random((NC, m)) < 0.5))
    res = []
    for k, fn in ((min(NC, gsk.RING_NARROW), gsk.lassosum_sweep),
                  (1, gsk.lassosum_sweep), (None, gsk.lassosum_sweep_plain)):
        if k is not None:
            plan_at(sb, NC, k, lasso=True)
        dp, beta = st["dp"].clone(), beta0.clone()
        out = fn(sb, dp, beta, st["bh"], pf, lam, delta, active)
        torch.cuda.synchronize()
        res.append((dp, beta) + tuple(out))
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(*res))


@pytest.mark.cuda
def test_unblocked_band_takes_the_global_dp_mode(cuda):
    """A one-block band of 30,000 variants in float64 (the unblocked
    samplers' band): its launches count as global ones; the sweep and the
    lassosum mode match their twins (1e-5; bit for bit)."""
    import scipy.sparse as sp

    from bigsnpr_tpu_torch import interop
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk
    from bigsnpr_tpu_torch.pgs.band import one_block_bands

    m, w = 30_000, 8
    rng = np.random.default_rng(11)
    up = sp.diags([np.ones(m)] + [0.9 ** d * rng.uniform(0.8, 1, m - d)
                                  for d in range(1, w + 1)],
                  list(range(w + 1)), format="csc").tocsc()
    corr = interop.sparse_ld_from_numpy(up.data, up.indices, up.indptr,
                                        up.shape)
    sb = one_block_bands(corr, dtype=np.float64).device_put(
        "cuda", dtype=np.float64)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")  # noqa: E731
    NC = 2
    st = dict(bh=f(rng.normal(0, 0.05, m)),
              C2=f(rng.uniform(0.1, 0.9, (NC, m))),
              C4=f(rng.uniform(0.1, 0.9, (NC, m))),
              s1=f(rng.uniform(1.0, 2.0, (NC, m))),
              u=f(rng.uniform(0, 1, (NC, m))), z=f(rng.normal(0, 1, (NC, m))),
              cb=f(rng.normal(0, 0.05, (NC, m))), inv_odd_p=f([2.0, 5.0]),
              p=f([0.3, 0.1]),
              sparse=torch.tensor([False, True], device="cuda"),
              dp=f(rng.normal(0, 0.05, (NC, sb.dp_len))))
    before = gsk.launches["sweep_global"]
    got = run_sweep(gsk.sweep, sb, st, 0.95, False)
    assert gsk.launches["sweep_global"] == before + 1
    ref = run_sweep(gsk.sweep_plain, sb, st, 0.95, False)
    assert torch.equal(got[2], ref[2])
    for a, b in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)
    pf, lam, delta = f(np.ones(m)), f([0.01, 0.001]), f([0.1, 1.0])
    active = torch.ones(NC, dtype=torch.bool, device="cuda")
    res = []
    for fn in (gsk.lassosum_sweep, gsk.lassosum_sweep_plain):
        dp, beta = sb.dp0(NC), torch.zeros((NC, m), dtype=torch.float64,
                                           device="cuda")
        out = fn(sb, dp, beta, st["bh"], pf, lam, delta, active)
        torch.cuda.synchronize()
        res.append((dp, beta) + tuple(out))
    assert all(torch.equal(a, b) for a, b in zip(*res))


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,width,NC,dtype", [
    ([333, 70], 5, 4, torch.float32),        # W < 32, rows % 32 != 0
    ([100, 31], 0, 3, torch.float32),        # W = 0
    ([45, 33], 31, 2, torch.float64),        # W just under a tile
    ([700], None, 30, torch.float64)])       # float64 at 30 chains
def test_ring_mode_edge_bands(cuda, sizes, width, NC, dtype):
    """The kernel on bands narrower than a tile, on rows that are not a
    multiple of 32, and in float64 at LDpred2-auto's 30 chains: the sweep
    against the twin (1e-5, causal equal) and bit-equal at two chains a
    CTA; the lassosum mode bit-equal to its twin, inactive grid points
    included; two launches bit-equal."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    sb, st = sweep_case(sizes, NC, 12, dtype, width=width)
    plan_at(sb, NC, min(2, NC))
    shared = run_sweep(gsk.sweep, sb, st, 0.95, True)
    sb.plans[NC] = gsk.plan(sb, NC, gsk.max_smem(cuda))
    got = run_sweep(gsk.sweep, sb, st, 0.95, True)
    again = run_sweep(gsk.sweep, sb, st, 0.95, True)
    ref = run_sweep(gsk.sweep_plain, sb, st, 0.95, True)
    assert torch.equal(got[2], ref[2])
    for a, b in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got, again, shared))
    rng = np.random.default_rng(13)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    m = sb.m
    bh, pf = st["bh"], f(rng.uniform(0.8, 1.5, m))
    lam, delta = f(rng.uniform(0.001, 0.05, NC)), f(rng.uniform(0.01, 1, NC))
    active = torch.as_tensor(np.arange(NC) % 3 != 1, device="cuda")
    beta0 = f(rng.normal(0, 0.05, (NC, m)) * (rng.random((NC, m)) < 0.5))
    res = []
    for fn in (gsk.lassosum_sweep, gsk.lassosum_sweep, gsk.lassosum_sweep_plain):
        dp, beta = st["dp"].clone(), beta0.clone()
        out = fn(sb, dp, beta, bh, pf, lam, delta, active)
        torch.cuda.synchronize()
        res.append((dp, beta) + tuple(out))
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(*res))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4),
                                        (torch.float64, 8)])
def test_ring_mode_on_the_widest_band_the_plan_takes(cuda, dtype, elem):
    """A 100-row band of the largest half-width whose ring still fits the
    device's shared memory (a random band: the kernel's arithmetic does not
    need it to be an LD matrix): the sweep against its twin and the
    lassosum mode bit-equal to its twin, at 3 chains."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    smem = gsk.max_smem(cuda)
    fixed = gsk.ring_smem_bytes(1, 0, elem)
    S = 1 << ((smem - fixed) // elem).bit_length() - 1
    W = (S - 3 * gsk.RING_ROWS) // 2
    rows, NC = 100, 3
    rng = np.random.default_rng(14)
    band = rng.normal(0, 0.01, (rows, 2 * W + 1))
    band[:, W] = 1.0
    sb = gsk.SweepBands([(band[None].astype(np.float32),
                          np.arange(rows, dtype=np.int32)[None])], rows,
                        cuda, dtype)
    pl = gsk.plan(sb, NC, smem)
    assert pl.ring_len == S
    with pytest.raises(ValueError):
        gsk.plan(gsk.SweepBands([(np.zeros((1, 4, 2 * W + 3), np.float32),
                                  np.arange(4, dtype=np.int32)[None])], 4,
                                cuda, dtype), NC, smem)
    sb.plans[NC] = pl
    f = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    st = dict(bh=f(rng.normal(0, 0.05, rows)),
              C2=f(rng.uniform(0.1, 0.9, (NC, rows))),
              C4=f(rng.uniform(0.1, 0.9, (NC, rows))),
              s1=f(rng.uniform(1.0, 2.0, (NC, rows))),
              u=f(rng.uniform(0, 1, (NC, rows))),
              z=f(rng.normal(0, 1, (NC, rows))),
              cb=f(rng.normal(0, 0.05, (NC, rows))), inv_odd_p=f([2., 5., 9.]),
              p=f([0.3, 0.1, 0.2]),
              sparse=torch.tensor([False, True, False], device="cuda"),
              dp=f(rng.normal(0, 0.05, (NC, sb.dp_len))))
    got = run_sweep(gsk.sweep, sb, st, 0.95, True)
    ref = run_sweep(gsk.sweep_plain, sb, st, 0.95, True)
    assert torch.equal(got[2], ref[2])
    for a, b in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1e-30)
    pf, lam, delta = f(np.ones(rows)), f([0.01, 0.001, 0.02]), f([0.1, 1., 2.])
    active = torch.tensor([True, False, True], device="cuda")
    res = []
    for fn in (gsk.lassosum_sweep, gsk.lassosum_sweep_plain):
        dp, beta = st["dp"].clone(), st["cb"].clone()
        out = fn(sb, dp, beta, st["bh"], pf, lam, delta, active)
        torch.cuda.synchronize()
        res.append((dp, beta) + tuple(out))
    assert all(torch.equal(a, b) for a, b in zip(*res))


@pytest.mark.cuda
@pytest.mark.parametrize("prod", [True, False])
def test_k1_k2_past_2_23(cuda, prod):
    """K2 at 2^23 + 4,097 variants (64 samples) and K1 at 2^23 + 4,097
    samples (64 variants): the plan splits the depth into runs of at most
    2^23, the result is within 1e-4 of max |twin| of the direct twin and
    within 1e-5 of max |float64 product|; an explicit splits=1 raises."""
    K = 2 ** 23 + 4097
    m, n = (K, 64) if prod else (64, K)
    g = torch.Generator(device=cuda).manual_seed(23)
    packed = torch.randint(0, 256, (m, (n + 3) // 4), dtype=torch.uint8,
                           device=cuda, generator=g)
    c = torch.rand(m, device=cuda, generator=g) * 2
    inv = torch.rand(m, device=cuda, generator=g) * 3
    W = torch.randn((m if prod else n, 20), device=cuda, generator=g)
    plan = gk.plane_plan(prod, 3, m, n, 20, gk._sm_count(cuda))
    assert plan["splits"] >= 2
    assert plan["kps"] * 64 * plan["ksub"] <= 2 ** 23
    kern, plain = (gk.prod, gk.prod_plain) if prod else (gk.cprod,
                                                         gk.cprod_plain)
    out, ref = kern(packed, n, W, c, inv), plain(packed, n, W, c, inv)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    if prod:
        ref64 = torch.zeros((n, 20), dtype=torch.float64, device=cuda)
        for j0 in range(0, m, 1 << 20):
            j1 = min(m, j0 + (1 << 20))
            ref64 += (dense64(packed[j0:j1], n, c[j0:j1], inv[j0:j1]).T
                      @ W[j0:j1].double())
    else:
        ref64 = dense64(packed, n, c, inv) @ W.double()
    assert (out.double() - ref64).abs().max() <= 1e-5 * ref64.abs().max()
    with pytest.raises(ValueError, match=r"2\^23"):
        kern(packed, n, W, c, inv, splits=1)


# --- slice 6c: the byte path of a DosagePack and snp_prodBGEN -------------

def _dosage_pack(n, m, seed):
    """A DosagePack of dosage codes 7..207 with 5% NA and 2% of the imputed
    hard-call codes 4..6."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(7, 208, (m, n)).astype(np.uint8)
    codes[rng.random((m, n)) < 0.05] = 3
    hard = rng.random((m, n)) < 0.02
    codes[hard] = rng.integers(4, 7, int(hard.sum()))
    return pt.DosagePack(codes=codes, n=n)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", [(1001, 3001, 1), (20003, 2000, 20)])
def test_byte_path_products_match_float64(cuda, n, m, l):
    """snp_cprodVec / snp_prodVec on a DosagePack (code256 gather + float32
    GEMM on the card) within 1e-5 of max |float64 product|, standardized
    and on the dosage scale."""
    from bigsnpr_tpu_torch.ops import matvec as pmv

    pack = _dosage_pack(n, m, l)
    sc = pt.snp_scaleBinom()(pack, device=cuda)
    d = torch.as_tensor(pack.code256, dtype=torch.float64,
                        device=cuda)[pack.device_codes(cuda).long()]
    rng = np.random.default_rng(l)
    V = rng.standard_normal((n, l))
    U = rng.standard_normal((m, l))
    for c, s in ((sc["center"], sc["scale"]), (np.zeros(m), np.ones(m))):
        c64 = torch.as_tensor(c, device=cuda)[:, None]
        s64 = torch.as_tensor(s, device=cuda)[:, None]
        X = torch.nan_to_num((d - c64) / s64, nan=0.0)
        for fn, W, ref in ((pmv.snp_cprodVec, V, X @ torch.as_tensor(
                V, device=cuda)), (pmv.snp_prodVec, U, X.T @ torch.as_tensor(
                    U, device=cuda))):
            out = torch.as_tensor(fn(pack, W, c, s, device=cuda),
                                  device=cuda).double().reshape(ref.shape)
            assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_byte_path_cor_matches_float64(cuda):
    """snp_cor on a DosagePack on the card (float64 pair sums) within 1e-9
    of float64 r on the decoded dosages."""
    pack = _dosage_pack(3001, 700, 3)
    corr = pt.snp_cor(pack, size=40, device=cuda)
    d = torch.as_tensor(pack.to_dosage().T, device=cuda)
    mk = (~torch.isnan(d)).double()
    x = torch.nan_to_num(d)
    A = torch.cat([x, x * x, mk])
    G = A @ A.T
    k = pack.m
    Sxy, Sx, Sy = G[:k, :k], G[:k, 2 * k:], G[2 * k:, :k]
    Sxx, Syy, Np = G[k:2 * k, 2 * k:], G[2 * k:, k:2 * k], G[2 * k:, 2 * k:]
    r = ((Sxy - Sx * Sy / Np) / torch.sqrt((Sxx - Sx * Sx / Np)
                                           * (Syy - Sy * Sy / Np)))
    D = corr.upper.toarray()
    ii, jj = np.nonzero(np.triu(D, 1))
    ref = np.clip(r.cpu().numpy()[ii, jj], -1, 1)
    assert len(ii) and np.abs(D[ii, jj] - ref).max() <= 1e-9


@pytest.mark.cuda
def test_prod_bgen_device_engine_matches_host(cuda, tmp_path):
    """snp_prodBGEN's device engine (float32 GEMM of exact pair sums, beta
    split hi + lo) within 5e-6 of the float64 host engine; NA propagates."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    rng = np.random.default_rng(4)
    m, N = 300, 5003
    x = rng.integers(0, 3, (m, N))
    p0 = np.where(x == 0, 255, rng.integers(0, 40, (m, N)) * (x == 1))
    p1 = np.minimum(np.where(x == 1, 200, 0), 255 - p0)
    miss = rng.random((m, N)) < 0.001
    blocks = chip_smoke.bgen_blocks(
        torch, torch.as_tensor(p0.astype(np.uint8)),
        torch.as_tensor(p1.astype(np.uint8)), torch.as_tensor(miss)).numpy()
    pos = np.arange(1, m + 1) * 10
    variants = {"chromosome": np.full(m, "01"), "position": pos,
                "rsid": np.array([f"rs{j}" for j in range(m)]),
                "varid": np.array([f"v{j}" for j in range(m)]),
                "allele1": np.full(m, "A"), "allele2": np.full(m, "G")}
    path = str(tmp_path / "t.bgen")
    chip_smoke.write_bgen(path, variants, N, [blocks])
    ids = [f"1_{p}_A_G" for p in pos]
    beta = rng.standard_normal((m, 2))
    host = pt.snp_prodBGEN(path, beta, ids, engine="host")
    for engine in ("device", "auto"):
        dev = pt.snp_prodBGEN(path, beta, ids, engine=engine, block_size=64,
                              device=cuda)
        assert np.array_equal(np.isnan(dev), np.isnan(host))
        ok = ~np.isnan(host)
        assert np.abs(dev - host)[ok].max() <= 5e-6 * np.abs(host[ok]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ridge", "boost"])
def test_impute_blocks_match_cpu_path(cuda, kind):
    """The ridge and boost blocks on the card against the same functions
    on the CPU on the same arrays: ridge within 1e-3 absolute (the same
    NaN rows), boost within 1e-4 with the same splits."""
    from bigsnpr_tpu_torch.core.unpack import pack_codes
    from bigsnpr_tpu_torch.utils import impute as pimp

    rng = np.random.default_rng(3)
    n, W, B, K = 4001, 300, 128, 16
    hap = np.empty((W, 2 * n), dtype=np.int64)
    hap[0] = rng.random(2 * n) < 0.3
    for j in range(1, W):
        hap[j] = np.where(rng.random(2 * n) < 0.9, hap[j - 1],
                          rng.random(2 * n) < 0.3)
    codes = np.array([3, 2, 0], np.uint8)[hap[:, :n] + hap[:, n:]]
    codes[rng.random((W, n)) < 0.05] = 1
    codes[7] = 1                                  # no training row
    packed = pack_codes(torch.as_tensor(codes))
    y_idx = np.resize(np.arange(W)[::2], B)
    y_idx[0] = 7
    nb = (y_idx[:, None] + rng.integers(-20, 21, (B, K))) % W
    args = [packed, n, torch.as_tensor(nb), torch.as_tensor(
        (rng.random((B, K)) < 0.95).astype(np.float32)),
        torch.as_tensor(y_idx), torch.as_tensor(
            (rng.random((B, n)) < 0.8).astype(np.float32))]
    dev = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    if kind == "ridge":
        out = pimp._impute_block_ridge(*dev, 1e-3)[0].cpu()
        ref = pimp._impute_block_ridge(*args, 1e-3)[0]
        nan = torch.isnan(ref)
        assert nan[0].all() and torch.equal(torch.isnan(out), nan)
        assert (out - ref)[~nan].abs().max() <= 1e-3
    else:
        out, _, _, sp = pimp._impute_block_boost(*dev, return_splits=True)
        ref, _, _, sp_ref = pimp._impute_block_boost(*args,
                                                     return_splits=True)
        assert (out.cpu() - ref).abs().max() <= 1e-4
        assert torch.equal(sp.cpu(), sp_ref)


@pytest.mark.cuda
def test_fast_impute_on_card_matches_cpu(cuda):
    """snp_fastImpute and the simple modes on the card against the CPU:
    info[0] and the simple modes bit-equal, imputed calls equal but for
    rounding flips (at most 0.1%)."""
    rng = np.random.default_rng(5)
    n, m = 2000, 1200
    hap = np.empty((m, 2 * n), dtype=np.int64)
    hap[0] = rng.random(2 * n) < 0.4
    for j in range(1, m):
        hap[j] = np.where(rng.random(2 * n) < 0.9, hap[j - 1],
                          rng.random(2 * n) < 0.4)
    X = (hap[:, :n] + hap[:, n:]).astype(float)
    X[rng.random((m, n)) < 0.05] = np.nan
    from bigsnpr_tpu_torch import interop
    from bigsnpr_tpu_torch.core import unpack

    packed = unpack.np_pack_codes(unpack.np_dosage_to_codes(X))
    chrom = {"chromosome": np.repeat([1, 2], m // 2)}
    for method in ("mode", "mean0", "random"):
        a = pt.snp_fastImputeSimple(interop.pack_from_numpy(packed, n),
                                    method, seed=1, device=cuda)
        b = pt.snp_fastImputeSimple(interop.pack_from_numpy(packed, n),
                                    method, seed=1, device="cpu")
        assert np.array_equal(a.packed, b.packed)
    na = np.isnan(X)
    for method in ("ridge", "boost"):
        a, ia = pt.snp_fastImpute(
            interop.pack_from_numpy(packed, n, map=chrom), seed=1,
            method=method, device=cuda)
        b, ib = pt.snp_fastImpute(
            interop.pack_from_numpy(packed, n, map=chrom), seed=1,
            method=method, device="cpu")
        assert np.array_equal(ia[0], ib[0])
        da, db = a.to_dosage().T[na], b.to_dosage().T[na]
        assert (da != db).sum() <= 1e-3 * na.sum()


@pytest.mark.cuda
def test_mesh_on_one_card_matches_geno_operator(cuda):
    """A 2 x 2 mesh of four shards on cuda:0: K1 / K2 launched once a tile
    a product, and cprod / prod / power within 1e-5 of max |float64| and
    of the single-device GenoOperator; LDpred2-auto's shard_chains and
    shard_blocks on two shards of the card bit-equal to the unsharded
    run."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk
    from bigsnpr_tpu_torch.parallel import mesh as pmesh

    n, m, l = 2003, 3001, 20
    pp = pt.snp_fake(n, m, seed=3, na_prob=0.02)
    sc = pt.bed_scaleBinom(pp, device=cuda)
    mesh = pmesh.make_mesh(devices=["cuda:0"] * 4)
    op = pmesh.MeshOperator(pp, sc["center"], sc["scale"], mesh=mesh)
    g = pt.GenoOperator(pp, sc["center"], sc["scale"], device=cuda)
    V = torch.randn(n, l, device=cuda)
    gk.reset_launches()
    B, Y = op.power_dev(V)
    torch.cuda.synchronize()
    assert gk.launches["cprod"] == 4 and gk.launches["prod"] == 4
    packed = pp.device_packed(cuda)
    X = dense64(packed, n, g.center, g.inv)
    B64 = X @ V.double()
    Y64 = X.T @ B.double()
    for got, ref64, ref in ((B, B64, g.cprod_dev(V)),
                            (Y, Y64, g.prod_dev(B))):
        scale = ref64.abs().max()
        assert (got.double() - ref64).abs().max() <= 1e-5 * scale
        assert (got - ref).abs().max() <= 1e-5 * scale
    cols = pt.snp_colstats(pp, device=cuda)
    st = pmesh.colstats_fn(mesh)(op.packed)[:, :m]
    np.testing.assert_array_equal(st[0], cols["sumX"])
    np.testing.assert_array_equal(st[2], cols["nona"])

    rng = np.random.default_rng(0)
    corr = pt.snp_cor(pp, size=100, device=cuda)
    df = {"beta": rng.normal(0, 0.02, m), "beta_se": np.full(m, 0.02),
          "n_eff": np.full(m, float(n))}
    blocks = pt.auto_blocks(corr, max_block=300)
    kw = dict(h2_init=0.2, vec_p_init=np.geomspace(0.01, 0.3, 6),
              burn_in=10, num_iter=10, blocks=blocks, device=cuda)
    ref = pt.snp_ldpred2_auto(corr, df, **kw)
    gsk.reset_launches()
    for shard in ("shard_chains", "shard_blocks"):
        got = pt.snp_ldpred2_auto(corr, df, mesh=["cuda:0"] * 2,
                                  **{shard: True}, **kw)
        for r, s in zip(ref, got):
            for k in ("beta_est", "path_h2_est", "path_p_est",
                      "path_alpha_est", "corr_est"):
                np.testing.assert_array_equal(s[k], r[k],
                                              err_msg=f"{shard} {k}")
    assert gsk.launches["sweep"] == 4 * 20


# the sites' shapes: a decoded block against a thin operand (the byte path,
# the projection, TorchOperator), a GRM block (6,704 variants of 10,000
# samples) and the imputation's ridge block (512 variants, 32 neighbours and
# the intercept, 20,000 samples)
PRECISION_SHAPES = {"mm": [(1, 301, 4097, 20)],
                    "addmm_": [(1, 301, 4097, 20), (1, 2000, 6704, 2000)],
                    "bmm": [(3, 301, 4097, 20), (512, 33, 20000, 33)]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["high", "default"])
@pytest.mark.parametrize("op", ["mm", "addmm_", "bmm"])
def test_precision_helpers_follow_the_cpu_rounding(cuda, name, op):
    """`ops/precision.py` on the card (bf16 tensor-core products, the depth
    in DEPTH_CHUNK pieces summed in float32) and on the CPU against
    float64 products of the same bf16 operands (the name's rounding rule):
    within 1e-6 of max |float64|, or within twice the error of the card's
    IEEE float32 product of those operands where a long depth makes that
    larger (tests/test_torch_precision.py holds the CPU rule at small
    shapes to 1e-6). No process-wide flag moves."""
    from bigsnpr_tpu_torch.ops import precision

    if op == "mm":
        fn = lambda x, y, z: precision.mm(x[0], y[0], name)  # noqa: E731
    elif op == "addmm_":
        fn = lambda x, y, z: precision.addmm_(  # noqa: E731
            z.clone(), x[0].mT.contiguous().mT, y[0], name)
    else:
        fn = lambda x, y, z: precision.bmm(x, y, name)  # noqa: E731
    for Bt, M, K, N in PRECISION_SHAPES[op]:
        g = torch.Generator(device=cuda).manual_seed(5)
        a = torch.randn((Bt, M, K), generator=g, device=cuda) + 0.5
        b = torch.randn((Bt, K, N), generator=g, device=cuda)
        acc = torch.randn((M, N), generator=g, device=cuda)
        A, B = precision.operands(a, b, name)
        ref = torch.bmm(A.double(), B.double())
        f32 = torch.bmm(A.float(), B.float())
        if op != "bmm":
            ref, f32 = ref[0], f32[0]
        if op == "addmm_":
            ref, f32 = ref + acc.double(), f32 + acc
        top = ref.abs().max()
        tol = max(1e-6, 2 * float((f32.double() - ref).abs().max() / top))
        got = fn(a, b, acc)
        assert got.dtype == torch.float32 and got.device == a.device
        assert (got.double() - ref).abs().max() <= tol * top
        rows = min(Bt, 2)            # the CPU rule on the first batches
        cpu = fn(a[:rows].cpu(), b[:rows].cpu(), acc.cpu())
        ref = ref[:rows] if op == "bmm" else ref
        assert (cpu.double() - ref.cpu()).abs().max() <= tol * top.cpu()
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.cuda
def test_spans_count_the_launches(cuda):
    """The recorder on the card: randomSVD's `svd.power` spans one a K1 /
    K2 pair and `svd.ritz` one a depth, LDpred2-grid's `gibbs.sweep` one
    a sweep launch, and `host_reads` the reads through `to_host`."""
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    pp = pt.snp_fake(1003, 2000, seed=5, na_prob=0.02)
    before = dict(gk.launches)
    with pt.recording() as rec:
        svd = pt.bed_randomSVD(pp, k=5, device=cuda)
    pairs = gk.launches["cprod"] - before["cprod"]
    assert gk.launches["prod"] - before["prod"] == pairs
    assert rec.n("svd.power") == pairs > 0
    assert rec.n("svd.ritz") == svd.niter
    assert rec.counters["host_reads"] == svd.niter + 4
    rng = np.random.default_rng(1)
    corr = pt.snp_cor(pp, size=100, device=cuda)
    df = {"beta": rng.normal(0, 0.02, 2000), "beta_se": np.full(2000, 0.02),
          "n_eff": np.full(2000, 1003.0)}
    grid = {"p": [0.01, 0.1], "h2": [0.2, 0.2], "sparse": [False, True]}
    s0 = gsk.launches["sweep"]
    with pt.recording() as rec:
        pt.snp_ldpred2_grid(corr, df, grid, burn_in=3, num_iter=4,
                            blocks=pt.auto_blocks(corr, max_block=300),
                            device=cuda)
    assert gsk.launches["sweep"] - s0 == rec.n("gibbs.sweep") == 7
    assert rec.counters["host_reads"] == 1


def counts_case(n, m, na, seed):
    """(m, ceil(n / 4)) bytes of random codes at NA rate `na`, variant 0
    monomorphic, variant 1 all NA, and random values in the last byte's
    pad bits."""
    from bigsnpr_tpu_torch.core.unpack import np_pack_codes

    rng = np.random.default_rng(seed)
    codes = rng.choice(np.array([0, 2, 3], np.uint8), (m, n))
    codes[rng.random((m, n)) < na] = 1
    codes[0], codes[1] = 3, 1
    packed = np_pack_codes(codes)
    if n % 4:
        pad = np.uint8((0xFF << (2 * (n % 4))) & 0xFF)
        packed[:, -1] |= rng.integers(0, 256, m, dtype=np.uint8) & pad
    return packed, codes, rng


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,na", [(1000, 300, 0.0), (1001, 301, 0.3),
                                    (1002, 17, 0.3), (1003, 513, 0.0),
                                    (37, 70_001, 0.3)])
def test_counts_kernel_matches_twin(cuda, n, m, na):
    """snp_counts' kernel bit-equal to its twin and to the codes, over
    every sample and over repeated, unsorted row indices: n = 0..3 mod 4,
    odd and even row lengths (rows start at any alignment), NA rates 0
    and 0.3, a monomorphic and an all-NA variant, set pad bits, and at n
    = 37 more rows than the grid's warps; one launch a call, and a second
    launch bit-equal to the first."""
    from bigsnpr_tpu_torch.ops.stats import counts_plain

    packed, codes, rng = counts_case(n, m, na, n + m)
    rows = rng.integers(0, n, 2 * n + 5)
    P = torch.as_tensor(packed, device=cuda)
    for ir in (None, rows):
        before = gk.launches["counts"]
        got = gk.counts(P, n, ir)
        assert gk.launches["counts"] == before + 1
        again = gk.counts(P, n, ir)
        twin = counts_plain(torch.as_tensor(packed), n,
                            None if ir is None else torch.as_tensor(ir))
        c = codes if ir is None else codes[:, ir]
        ref = np.stack([(c == k).sum(1) for k in (3, 2, 0, 1)])
        assert torch.equal(got, again)
        np.testing.assert_array_equal(got.cpu().numpy(), twin.numpy())
        np.testing.assert_array_equal(twin.numpy(), ref)
    k = len(rows)                # the monomorphic and the all-NA variant
    np.testing.assert_array_equal(got[:, :2].cpu().numpy(),
                                  [[k, 0], [0, 0], [0, 0], [0, k]])
    pp = pt.GenoPack(packed=packed, n=n)
    np.testing.assert_array_equal(pt.snp_counts(pp, device=cuda)[:, :2],
                                  [[n, 0], [0, 0], [0, 0], [0, n]])
    np.testing.assert_array_equal(pt.snp_counts(pp, ind_row=rows, device=cuda),
                                  pt.snp_counts(pp, ind_row=rows, device="cpu"))


@pytest.mark.cuda
def test_counts_kernel_never_syncs(cuda):
    """The counts kernel issues no synchronizing call, and snp_counts
    syncs as often (its one read of the counts) at 300 variants as at
    200,000, where the twin decodes four blocks."""
    import warnings

    P = torch.randint(0, 256, (2000, 251), dtype=torch.uint8, device=cuda)
    gk.counts(P, 1001)                   # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gk.counts(P, 1001)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    def syncs(m):
        pp = pt.GenoPack(packed=counts_case(37, m, 0.1, m)[0], n=37)
        pp.device_packed(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                pt.snp_counts(pp, device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(x.message) for x in w)

    assert syncs(300) == syncs(200_000)
