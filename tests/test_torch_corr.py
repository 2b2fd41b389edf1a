"""Port parity: windowed LD (`snp_cor`), its exact integer pair sums, and
LD scores, against the JAX package on the same packs.

The pair sums are integers, so they are compared bit for bit; so is the
host finalize's `upper` (same float64 formula on the same integers). The
device finalize rounds r to float32 on both sides: within 3e-7 of the
JAX package's error-free-transform finalize. LD scores: rtol 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bigsnpr_tpu as bt
from bigsnpr_tpu.ops import corr as jcorr
from bigsnpr_tpu.ops import ldscores as jld
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.ops import corr as pcorr
from bigsnpr_tpu_torch.ops import ldscores as pld

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def packs(n, m, na, seed):
    jp = bt.snp_fake(n, m, seed=seed, na_prob=na)
    return jp, interop.pack_from_numpy(np.asarray(jp.packed), n)


def same_csc(a, b):
    a, b = a.upper, b.upper
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data, equal_nan=True))


@pytest.mark.parametrize("n", [200, 201, 202, 203])
@pytest.mark.parametrize("na", [0.0, 0.07])
def test_pair_sums_bit_equal(n, na):
    jp, pp = packs(n, 90, na, seed=n)
    fixed = jcorr._na_pad_tail(np.asarray(jp.packed), n)
    jt, jb = jnp.asarray(fixed[60:90]), jnp.asarray(fixed[20:90])
    pt_, pb_ = (torch.as_tensor(np.asarray(pp.packed)[a:b])
                for a, b in ((60, 90), (20, 90)))
    ref = jcorr._pair_sums_block(jt, jb, n, "highest")
    got = pcorr._pair_sums_block(pt_, pb_, n)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64))
    if na == 0.0:
        ref = jcorr._pair_sums_nona_compact(jt, jb, n, "highest")
        got = pcorr._pair_sums_nona_compact(pt_, pb_, n)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(r).astype(np.int64))
        # the NA-free path gives the NA-aware path's integers
        full = pcorr._pair_sums_block(pt_, pb_, n, nona=True)
        for a, b in zip(full, pcorr._pair_sums_block(pt_, pb_, n)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_float64_product_past_the_int32_guard(monkeypatch):
    """Past 16 n < 2^31 (4 n on the NA-free path) the product runs in
    float64: the same integers."""
    _, pp = packs(203, 40, 0.05, seed=1)
    P = torch.as_tensor(np.asarray(pp.packed))
    ref = pcorr._pair_sums_block(P[10:], P, 203)
    ref_nona = pcorr._pair_sums_nona_compact(P[10:], P, 203)
    assert pcorr._int32_exact(203, 16) and not pcorr._int32_exact(2**27, 16)
    assert pcorr._int32_exact(2**28, 4) and not pcorr._int32_exact(2**29, 4)
    monkeypatch.setattr(pcorr, "_int32_exact", lambda n, mp: False)
    for a, b in zip(pcorr._pair_sums_block(P[10:], P, 203), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(pcorr._pair_sums_nona_compact(P[10:], P, 203), ref_nona):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sample_chunks_give_the_same_sums(monkeypatch):
    _, pp = packs(1003, 50, 0.05, seed=2)
    P = torch.as_tensor(np.asarray(pp.packed))
    ref = pcorr._pair_sums_block(P[20:], P, 1003)
    monkeypatch.setattr(pcorr, "_PLANE_BYTES", 3 * 80 * 4 * 16)
    assert len(list(pcorr._chunks(1003, 80))) > 4
    for a, b in zip(pcorr._pair_sums_block(P[20:], P, 1003), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,na,kw", [
    (301, 0.0, dict()),
    (302, 0.05, dict()),
    (303, 0.05, dict(alpha=0.05, thr_r2=0.01)),
    (300, 0.0, dict(alpha=0.2, thr_r2=0.05, size=25)),
    (301, 0.1, dict(fill_diag=False, block=32)),
])
def test_snp_cor_host_bit_equal(n, na, kw):
    jp, pp = packs(n, 230, na, seed=7)
    kw = dict(dict(size=40, block=64), **kw)
    ref = jcorr.snp_cor(jp, **kw)
    got = pcorr.snp_cor(pp, **kw)
    assert same_csc(got, ref)
    np.testing.assert_array_equal(got.pos, ref.pos)


def test_snp_cor_subset_and_positions_bit_equal():
    jp, pp = packs(250, 200, 0.05, seed=9)
    rows = np.sort(np.random.default_rng(0).choice(250, 181, replace=False))
    cols = np.arange(10, 190)
    pos = np.cumsum(np.random.default_rng(1).integers(1, 3000, len(cols)))
    kw = dict(ind_row=rows, ind_col=cols, size=30, infos_pos=pos,
              thr_r2=0.01)
    assert same_csc(pcorr.snp_cor(pp, **kw), jcorr.snp_cor(jp, **kw))


@pytest.mark.parametrize("n,na,kw", [
    (301, 0.0, dict()),
    (303, 0.05, dict(alpha=0.05, thr_r2=0.01)),
])
def test_snp_cor_device_finalize(n, na, kw):
    """Device finalize: float64 r rounded to float32; within 3e-7 of the
    JAX package's device finalize and of the host float64 values."""
    jp, pp = packs(n, 230, na, seed=11)
    kw = dict(dict(size=40, block=64), **kw)
    got = pcorr.snp_cor(pp, finalize="device", **kw)
    ref = jcorr.snp_cor(jp, finalize="device", **kw)
    host = pcorr.snp_cor(pp, **kw)
    d, r, h = got.to_dense(), ref.to_dense(), host.to_dense()
    assert np.array_equal(d != 0, h != 0)
    assert np.abs(d - r).max() <= 3e-7
    assert np.abs(d - h).max() <= 3e-7
    np.testing.assert_array_equal(d, h.astype(np.float32).astype(np.float64))


def test_ld_scores_match_jax():
    jp, pp = packs(301, 150, 0.05, seed=13)
    jc = jcorr.snp_cor(jp, size=30)
    pc = pcorr.snp_cor(pp, size=30)
    sub = np.arange(0, 150, 3)
    for ind in (None, sub):
        np.testing.assert_allclose(pld.ld_scores_sfbm(pc, ind_sub=ind),
                                   jld.ld_scores_sfbm(jc, ind_sub=ind),
                                   rtol=1e-12)
    np.testing.assert_allclose(pld.snp_ld_scores(pp, size=30),
                               jld.snp_ld_scores(jp, size=30), rtol=1e-12)


def test_sparse_ld_npz_round_trip(tmp_path):
    jp, pp = packs(201, 80, 0.0, seed=15)
    pc = pcorr.snp_cor(pp, size=20)
    path = pc.save(tmp_path / "ld")
    back = jcorr.SparseLD.load(path)
    assert same_csc(pc, back)
    again = pcorr.SparseLD.load(jcorr.snp_cor(jp, size=20).save(
        tmp_path / "ld2.npz"))
    assert same_csc(again, pc)
    np.testing.assert_array_equal(pc.subset(np.arange(0, 80, 2)).to_dense(),
                                  back.subset(np.arange(0, 80, 2)).to_dense())
