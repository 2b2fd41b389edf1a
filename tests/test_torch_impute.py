"""Imputation: the port's `utils/impute.py` against the JAX package's on
the same packs. The simple modes are bit-equal (integer counts, the same
host stream for "random", drawn in row chunks); the ridge and boost
blocks within 1e-5 on the same arrays, the boost's splits the same;
`snp_fastImpute` with `info[0]` bit-equal and the imputed codes equal but
for counted rounding flips; the ntr = 0 cases, resumption, the neighbour
table and the on-device write-back; and a small .bed -> impute ->
autoSVD -> GWAS chain."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core import unpack as junpack
from bigsnpr_tpu.core.genotypes import GenoPack as JaxGenoPack
from bigsnpr_tpu.utils import impute as jimp
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.utils import impute as pimp

from oracle_native import private_native

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    yield from private_native(tmp_path_factory)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def both(X, map_=None):
    """(n, m) dosages (NaN = missing) as a JAX pack and a port pack."""
    n = X.shape[0]
    packed = junpack.np_pack_codes(junpack.np_dosage_to_codes(X.T))
    jmap = None
    if map_ is not None:
        import pandas as pd

        jmap = pd.DataFrame(map_)
    return (JaxGenoPack(packed=packed, n=n, map=jmap),
            interop.pack_from_numpy(packed, n, map=map_))


def ld_cohort(n, m, seed, na=0.1, p=0.4):
    """tests/test_impute_project.py:51-58: haplotypes that copy the
    previous variant with probability 0.9; `na` of the calls missing."""
    rng = np.random.default_rng(seed)
    hap = np.empty((2 * n, m), dtype=np.int8)
    hap[:, 0] = rng.random(2 * n) < p
    for j in range(1, m):
        copy = rng.random(2 * n) < 0.9
        hap[:, j] = np.where(copy, hap[:, j - 1], rng.random(2 * n) < p)
    X = (hap[:n] + hap[n:]).astype(float)
    mask = rng.random((n, m)) < na
    Xo = X.copy()
    Xo[mask] = np.nan
    return X, Xo, mask


def nonadditive_cohort(n, m, seed=0):
    """tests/test_impute_project.py:205-214: every 4th variant is 1 where
    its left neighbour is heterozygous, else 2; 15% missing."""
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, 0.4, size=(n, m)).astype(float)
    for j in range(1, m, 4):
        X[:, j] = (X[:, j - 1] == 1) * 1.0 + (X[:, j - 1] != 1) * 2.0
    na = rng.random((n, m)) < 0.15
    Xo = X.copy()
    Xo[na] = np.nan
    return X, Xo, na


def two_chromosome_pack():
    """snp_fake's kind of pack on 2 chromosomes, with an all-NA and a
    monomorphic variant."""
    jf = bt.snp_fake(150, 80, seed=5, na_prob=0.1)
    X = jf.to_dosage()
    X[:, 7] = np.nan
    X[:, 11] = 2.0
    map_ = {"chromosome": np.repeat([1, 2], 40)}
    return both(X, map_)


def fake_pack():
    jp = bt.snp_fake(200, 60, seed=41, na_prob=0.15)
    return jp, interop.pack_from_numpy(np.asarray(jp.packed), jp.n)


PACKS = {"fake": fake_pack, "two_chromosomes": two_chromosome_pack}


@pytest.mark.parametrize("which", sorted(PACKS))
@pytest.mark.parametrize("method", ["mode", "mean0", "random", "mean2",
                                    "dosage"])
def test_simple_modes_bit_equal(which, method):
    jp, pp = PACKS[which]()
    if method == "dosage":
        np.testing.assert_array_equal(
            pimp.snp_fastImputeSimple_dosage(pp),
            jimp.snp_fastImputeSimple_dosage(jp))
        return
    j = jimp.snp_fastImputeSimple(jp, method, seed=3)
    p = pt.snp_fastImputeSimple(pp, method, seed=3)
    if method == "mean2":
        np.testing.assert_array_equal(p.codes, np.asarray(j.codes))
        np.testing.assert_array_equal(p.code256, np.asarray(j.code256))
        # the byte path's float64 colstats (tests/test_torch_dosage.py)
        np.testing.assert_allclose(pt.snp_MAF(p), bt.snp_MAF(j), rtol=1e-12)
    else:
        np.testing.assert_array_equal(p.packed, np.asarray(j.packed))
        assert np.array_equal(p.device_packed("cpu").numpy(), p.packed)


@pytest.mark.parametrize("entries", [1, 250, 1 << 23])
def test_random_replay_in_chunks_equals_one_call(monkeypatch, entries):
    """The chunked binomial stream (rows of `entries // n`, at least one)
    equals one draw over all m x n entries."""
    jp, pp = fake_pack()
    monkeypatch.setattr(pimp, "_DRAW_ENTRIES", entries)
    monkeypatch.setattr(pimp, "pick_block", lambda n: 2)   # 8 rows
    out = pt.snp_fastImputeSimple(pp, "random", seed=11)
    counts = pt.snp_counts(pp)
    c = np.maximum(counts[:3].sum(0), 1)
    af = (0.5 * counts[1] + counts[2]) / c
    draws = np.random.default_rng(11).binomial(
        2, np.broadcast_to(af[:, None], (pp.m, pp.n)))
    codes = junpack.np_unpack_codes(pp.packed, pp.n)
    fill = junpack.np_dosage_to_codes(draws.astype(float))
    ref = junpack.np_pack_codes(np.where(codes == 1, fill, codes))
    np.testing.assert_array_equal(out.packed, ref)


def test_simple_bad_method_raises():
    _, pp = fake_pack()
    with pytest.raises(ValueError, match="method should be"):
        pt.snp_fastImputeSimple(pp, "median")


def block_inputs(Xo, B, K, W, seed, empty_rows=()):
    """One block's arrays: a W-variant window, B targets (some repeated, as
    the padded target list), K neighbours each (some invalid), a train
    mask; `empty_rows` targets get no training row (ntr = 0)."""
    rng = np.random.default_rng(seed)
    n = Xo.shape[0]
    packed = junpack.np_pack_codes(junpack.np_dosage_to_codes(Xo[:, :W].T))
    y_idx = np.resize(rng.permutation(W)[:B // 2 + 1], B).astype(np.int32)
    nb = np.stack([(y + rng.choice(np.arange(-6, 7), K, replace=False)) % W
                   for y in y_idx]).astype(np.int32)
    valid = (rng.random((B, K)) < 0.9).astype(np.float32)
    train = (rng.random((B, n)) < 0.8).astype(np.float32)
    for b in empty_rows:
        train[b] = 0.0
    return packed, nb, valid, y_idx, train


def port_block(fn, arrays, n, **kw):
    packed, nb, valid, y_idx, train = arrays
    return fn(torch.as_tensor(packed), n, torch.as_tensor(nb).long(),
              torch.as_tensor(valid), torch.as_tensor(y_idx).long(),
              torch.as_tensor(train), **kw)


def jax_block(make, arrays):
    import jax.numpy as jnp

    return [np.asarray(a) for a in make(*map(jnp.asarray, arrays))]


@pytest.mark.parametrize("seed", [0, 1])
def test_ridge_block_matches_jax(seed):
    _, Xo, _ = ld_cohort(301, 40, seed)
    B, K, W = 24, 6, 40
    arrays = block_inputs(Xo, B, K, W, seed, empty_rows=(3,))
    jp, jy, jna = jax_block(jimp._impute_block_fn(301, W, K, B, 1e-3),
                            arrays)
    pp, py, pna = port_block(pimp._impute_block_ridge, arrays, 301,
                             ridge=1e-3)
    np.testing.assert_array_equal(py.numpy(), jy)
    np.testing.assert_array_equal(pna.numpy(), jna)
    # ntr = 0: no factor, NaN predictions in both
    assert np.isnan(jp[3]).all() and np.isnan(pp[3].numpy()).all()
    ok = np.arange(B) != 3
    assert np.isfinite(jp[ok]).all()
    np.testing.assert_allclose(pp.numpy()[ok], jp[ok], rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_boost_block_matches_jax(seed):
    """Final predictions within 1e-5, and every round's split the same:
    the JAX package's round-r step (its preds after r rounds minus after
    r - 1) is one value on the port's chosen LEFT set and one on its
    complement, and the two steps agree within 1e-5."""
    X, Xo, _ = nonadditive_cohort(257, 48, seed)
    B, K, W, R = 20, 5, 48, 10
    arrays = block_inputs(Xo, B, K, W, seed, empty_rows=(2,))
    n = 257
    pp, py, pna, splits = port_block(pimp._impute_block_boost, arrays, n,
                                     n_rounds=R, return_splits=True)
    jp, jy, jna = jax_block(jimp._impute_block_boost_fn(n, W, K, B, R),
                            arrays)
    np.testing.assert_array_equal(py.numpy(), jy)
    np.testing.assert_allclose(pp.numpy(), jp, rtol=0, atol=1e-5)
    codes = junpack.np_unpack_codes(arrays[0], n)
    cls = np.where(codes == 1, 3, 2 - ((codes.astype(int) + 1) >> 1))
    left = np.asarray(pimp._LEFT)
    prev_j = prev_t = None
    for r in range(1, R + 1):
        jr = jax_block(jimp._impute_block_boost_fn(n, W, K, B, r), arrays)[0]
        tr = port_block(pimp._impute_block_boost, arrays, n,
                        n_rounds=r)[0].numpy()
        np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5)
        if r > 1:
            for b in range(B):
                ci, ki = splits[r - 1, b].tolist()
                in_left = left[ci][cls[arrays[1][b, ki]]] > 0
                for step in (jr[b] - prev_j[b], tr[b] - prev_t[b]):
                    for side in (in_left, ~in_left):
                        if side.any():
                            assert np.ptp(step[side]) < 1e-6, (r, b)
        prev_j, prev_t = jr, tr


def flips(jo, po, na_mask):
    """Imputed calls that differ between the packages: each one step apart
    (a rounding flip at .5 or 1.5); returns their count."""
    a = jo.to_dosage()[na_mask]
    b = po.to_dosage()[na_mask]
    both_nan = np.isnan(a) & np.isnan(b)
    diff = ~both_nan & (a != b)
    assert np.all(np.abs(a[diff] - b[diff]) == 1), "not a rounding flip"
    return int(diff.sum())


@pytest.mark.parametrize("method", ["ridge", "boost"])
def test_fast_impute_matches_jax(method):
    X, Xo, mask = ld_cohort(600, 60, 7)
    jp, pp = both(Xo)
    jo, jinfo = bt.snp_fastImpute(jp, seed=1, method=method)
    po, pinfo = pt.snp_fastImpute(pp, seed=1, method=method)
    np.testing.assert_array_equal(pinfo[0], jinfo[0])
    np.testing.assert_allclose(pinfo[0], mask.mean(0), atol=1e-12)
    n_flip = flips(jo, po, mask)
    assert n_flip <= 1e-3 * mask.sum(), n_flip
    np.testing.assert_allclose(pinfo[1], jinfo[1], atol=2 / 600)
    # the JAX rule: the model beats the mode by 30%
    Xi = po.to_dosage()
    assert not np.isnan(Xi).any()
    mode = pt.snp_fastImputeSimple(pp, "mode").to_dosage()
    err = np.mean(Xi[mask] != X[mask])
    err_mode = np.mean(mode[mask] != X[mask])
    assert err < 0.7 * err_mode, (err, err_mode)


def test_fast_impute_nonadditive_matches_jax():
    """tests/test_impute_project.py:199's rule in both packages: boost
    below 0.15 and half the ridge's error on the non-additive variants."""
    X, Xo, na = nonadditive_cohort(900, 160)
    jp, pp = both(Xo)
    struct = np.zeros(160, bool)
    struct[1::4] = True
    sel = na & struct[None, :]
    errs = {}
    for method in ("ridge", "boost"):
        jo, jinfo = bt.snp_fastImpute(jp, seed=1, method=method)
        po, pinfo = pt.snp_fastImpute(pp, seed=1, method=method)
        np.testing.assert_array_equal(pinfo[0], jinfo[0])
        assert flips(jo, po, na) <= 1e-3 * na.sum()
        Xi = po.to_dosage()
        assert not np.isnan(Xi).any()
        errs[method] = np.mean(Xi[sel] != X[sel])
    assert errs["boost"] < 0.15, errs
    assert errs["boost"] < 0.5 * errs["ridge"], errs


@pytest.mark.parametrize("method", ["ridge", "boost"])
def test_no_training_row_left_missing_as_jax(method):
    """ntr = 0 in both of its forms: a variant with every call missing
    (info[1] stays NaN) and variants whose one call falls in validation
    (info[1] = 1.0); their calls stay missing, as in the JAX package. A
    lone call that falls in training leaves one training row against K + 1
    ridge features: a near-singular solve whose float32 predictions
    differ between the packages by more than rounding, so those variants
    are held to no call left missing."""
    _, Xo, _ = ld_cohort(200, 50, 3, na=0.05)
    Xo[:, 10] = np.nan
    rng = np.random.default_rng(0)
    lone = np.arange(20, 50, 2)
    for j in lone:
        keep = rng.integers(200)
        Xo[np.arange(200) != keep, j] = np.nan
    jp, pp = both(Xo)
    jo, jinfo = bt.snp_fastImpute(jp, seed=4, method=method)
    po, pinfo = pt.snp_fastImpute(pp, seed=4, method=method)
    np.testing.assert_array_equal(pinfo, jinfo)
    jX, pX = jo.to_dosage(), po.to_dosage()
    left = np.isnan(pX).any(0)
    np.testing.assert_array_equal(left, np.isnan(jX).any(0))
    assert pinfo[0, 10] == 1.0 and np.isnan(pinfo[1, 10])
    if method == "boost":
        # the stumps start from the training mean, 0 with no training row
        np.testing.assert_array_equal(pX, jX)
        assert not left.any() and (pX[:, 10] == 0).all()
        return
    in_val = lone[pinfo[1, lone] == 1.0]
    in_train = lone[np.isnan(pinfo[1, lone])]
    same = np.setdiff1d(np.arange(50), in_train)
    np.testing.assert_array_equal(pX[:, same], jX[:, same])
    assert left[10] and len(in_val) > 0 and len(in_train) > 0
    assert left[in_val].all()
    assert not left[np.setdiff1d(np.arange(50), np.r_[10, in_val])].any()


def test_resume_with_info_matches_jax():
    """A finished `info` makes a second call a copy; a half-finished one
    resumes on the rest, whose stream skips the finished chromosome and
    blocks, as the JAX package's does."""
    _, Xo, _ = ld_cohort(300, 90, 9)
    map_ = {"chromosome": np.repeat([1, 2, 3], 30)}
    jp, pp = both(Xo, map_)
    po, pinfo = pt.snp_fastImpute(pp, seed=2, block=8, size=5)
    again, info2 = pt.snp_fastImpute(po, info=pinfo.copy(), seed=9)
    np.testing.assert_array_equal(again.packed, po.packed)
    np.testing.assert_array_equal(info2, pinfo)
    part = pinfo.copy()
    part[:, :30] = np.nan          # chromosome 1 to do again
    part[:, 40:48] = np.nan        # one block of chromosome 2
    jo, jinfo = bt.snp_fastImpute(jp, info=part.copy(), seed=5, block=8,
                                  size=5)
    po2, pinfo2 = pt.snp_fastImpute(pp, info=part.copy(), seed=5, block=8,
                                    size=5)
    np.testing.assert_array_equal(pinfo2, jinfo)
    np.testing.assert_array_equal(po2.packed, np.asarray(jo.packed))


def test_neighbour_table_matches_jax():
    """snp_cor's symmetric matrix is bit-equal, so the top-K table (with
    the positional fallback) is the JAX package's; each row holds the K
    largest |r| of its variant."""
    _, Xo, _ = ld_cohort(400, 120, 5)
    Xo[:, 30] = np.nan                       # no neighbour: the fallback
    jp, pp = both(Xo)
    rows = np.sort(np.random.default_rng(0).choice(400, 300, replace=False))
    kw = dict(ind_row=rows, size=20, alpha=1e-4, fill_diag=False)
    jc = bt.snp_cor(jp, **kw).sym().tocsc()
    pc = pt.snp_cor(pp, **kw).sym().tocsc()
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(pc, a), getattr(jc, a))
    K = 8
    tab, val = pimp._neighbour_table(pc, 120, 20, K)
    for i in range(120):
        lo, hi = pc.indptr[i], pc.indptr[i + 1]
        # argpartition of -|r| puts NaN (pairs with the all-NA variant) last
        r = np.nan_to_num(np.abs(pc.data[lo:hi]), nan=-1.0)
        k = int(val[i].sum())
        if hi - lo >= 5:
            assert k == min(K, hi - lo)
            kth = np.sort(r)[::-1][k - 1]
            r_of = dict(zip(pc.indices[lo:hi], r))
            got = np.array([r_of[j] for j in tab[i, :k]])
            assert (got >= kth).all()
        else:
            assert k == K and i not in tab[i, :k]


def test_write_back_equals_per_row_host_loop():
    """The device write-back against the JAX package's per-row unpack /
    assign / repack on the same predictions (n not a multiple of 4, NaN,
    .5 and 1.5 predictions, pad bits set in the original bytes)."""
    rng = np.random.default_rng(1)
    n, B = 203, 30
    codes = rng.choice(np.array([0, 1, 2, 3], np.uint8), size=(B, n))
    codes[5] = 0                                   # a row without NA
    packed = junpack.np_pack_codes(codes)
    packed[:, -1] |= 0xC0                          # pad bits of the last byte
    preds = rng.uniform(-0.5, 2.5, (B, n)).astype(np.float32)
    preds[rng.random((B, n)) < 0.05] = np.nan
    preds[:, :8] = [0.5, 1.5, 2.5, -0.5, 0.49, 1.51, 2.0, 0.0]
    y_na = codes == 1
    ref = packed.copy()
    for t in range(B):
        na_rows = y_na[t]
        if na_rows.sum():
            filled = np.rint(np.clip(preds[t, na_rows], 0, 2))
            row = junpack.np_unpack_codes(ref[t][None, :], n)[0]
            row[na_rows] = junpack.np_dosage_to_codes(filled[None, :])[0]
            ref[t] = junpack.np_pack_codes(row[None, :])[0]
    out = pimp._write_back(torch.as_tensor(packed), n, torch.as_tensor(preds),
                           torch.as_tensor(y_na))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_impute_chain_matches_jax(tmp_path):
    """.bed with NA -> read -> snp_fastImpute -> snp_autoSVD ->
    big_univLinReg(covar = PCs), both packages, at
    tests/test_torch_slice.py's chain tolerances."""
    n, m = 400, 600
    X, Xo, _ = ld_cohort(n, m, 21, na=0.02, p=0.3)
    rng = np.random.default_rng(2)
    pop = rng.integers(0, 2, n)
    shift = rng.random(m) < 0.3                      # population structure
    Xo[np.ix_(pop == 1, shift)] = np.where(
        np.isnan(Xo[np.ix_(pop == 1, shift)]), np.nan,
        np.clip(Xo[np.ix_(pop == 1, shift)] + 1, 0, 2))
    meta = bt.snp_fake(n, m, seed=1)
    jmap = meta.map.copy()
    jmap["chromosome"] = np.repeat([1, 2], m // 2)
    packed = junpack.np_pack_codes(junpack.np_dosage_to_codes(Xo.T))
    src = JaxGenoPack(packed=packed, n=n, fam=meta.fam, map=jmap)
    bed = bt.snp_writeBed(src, tmp_path / "na.bed")
    jp, pp = bt.snp_readBed(bed), pt.snp_readBed(bed)
    jo, jinfo = bt.snp_fastImpute(jp, seed=1)
    po, pinfo = pt.snp_fastImpute(pp, seed=1)
    np.testing.assert_array_equal(pinfo[0], jinfo[0])
    assert flips(jo, po, np.isnan(Xo)) <= 1e-3 * np.isnan(Xo).sum()
    kw = dict(k=3, thr_r2=0.2, roll_size=10)
    ja = bt.snp_autoSVD(jo, **kw)
    pa = pt.snp_autoSVD(po, **kw)
    np.testing.assert_array_equal(pa.subset, ja.subset)
    np.testing.assert_allclose(pa.d, ja.d, rtol=1e-4)
    y = X[:, :50] @ rng.standard_normal(50) + rng.standard_normal(n)
    jg = bt.big_univLinReg(jo, y, covar=ja.u)
    pg = pt.big_univLinReg(po, y, covar=ja.u)
    for key in ("estim", "std.err"):
        ref = jg[key].to_numpy()
        np.testing.assert_allclose(pg[key], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
