"""The port's byte-coded dosages (`DosagePack`, the code tables, the `.dpk`
store, interop) and every byte-code branch of the ported modules against
the JAX package on the same DosagePack (tests/test_dosage_ops.py's kind:
dosage codes 7..207, 5% code 3 = NA, and hard-call codes 4..6).

Tolerances: tables, views, stores, colstats' counts and clump sets exact;
colstats' float64 sums 1e-12 relative; the byte products (float32 GEMMs
in two orders) 1e-5 of max |JAX|; randomSVD's d 1e-4 relative (two Krylov
solvers at tol 1e-6); snp_cor's r and LD scores 1e-5 (the JAX package's
float32 sums against the port's float64 ones)."""

import numpy as np
import pandas as pd
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core import codes as jcodes
from bigsnpr_tpu.core.dosage import DosagePack as JaxDosagePack
from bigsnpr_tpu.ops import clumping as jclump
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.core import codes as pcodes

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def dosage_codes(seed=81, m=60, n=150):
    """(m, n) byte codes as in tests/test_dosage_ops.py, plus 2% of the
    imputed hard-call codes 4..6."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(7, 208, size=(m, n)).astype(np.uint8)
    codes[rng.random((m, n)) < 0.05] = 3
    hard = rng.random((m, n)) < 0.02
    codes[hard] = rng.integers(4, 7, int(hard.sum()))
    return codes


@pytest.fixture(scope="module")
def packs():
    codes = dosage_codes()
    m, n = codes.shape
    fam = pd.DataFrame({"family.ID": [f"F{i}" for i in range(n)],
                        "sample.ID": [f"S{i}" for i in range(n)]})
    mp = pd.DataFrame({"chromosome": np.repeat([1, 2], m // 2),
                       "marker.ID": [f"rs{j}" for j in range(m)],
                       "physical.pos": np.arange(1, m + 1) * 1000,
                       "info": np.linspace(0.5, 1, m)})
    jd = JaxDosagePack(codes=codes, n=n, fam=fam, map=mp)
    pd_ = interop.dosage_from_numpy(codes, n, fam=fam, map=mp)
    return jd, pd_


def same_columns(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert len(x) == len(y), k
        assert all(u == v for u, v in zip(x.tolist(), y.tolist())), k


@pytest.mark.parametrize("name", ["CODE_012", "CODE_DOSAGE",
                                  "CODE_IMPUTE_PRED"])
def test_code_tables_equal(name):
    a, b = getattr(jcodes, name), getattr(pcodes, name)
    assert a.shape == b.shape == (256,)
    assert np.array_equal(a, b, equal_nan=True)
    assert np.array_equal(getattr(pt, name), b, equal_nan=True)


def test_views_equal_jax(packs):
    """to_dosage, subset (host and on the device copy) and
    round_to_hardcalls (both ways) equal the JAX package's."""
    jd, pd_ = packs
    assert pd_.shape == jd.shape and pd_.m == jd.m
    assert np.array_equal(pd_.to_dosage(), jd.to_dosage(), equal_nan=True)
    rows, cols = np.arange(3, 150, 4), np.array([7, 1, 40, 33, 2])
    js = jd.subset(ind_row=rows, ind_col=cols)
    ph = pd_.subset(ind_row=rows, ind_col=cols)
    fresh = interop.dosage_from_numpy(jd.codes, jd.n)
    fresh.device_codes("cpu")
    pdv = fresh.subset(ind_row=rows, ind_col=cols)
    for sub in (ph, pdv):
        assert np.array_equal(sub.codes, js.codes) and sub.n == js.n
    same_columns(ph.map, js.map)
    same_columns(ph.fam, js.fam)
    jh = jd.round_to_hardcalls()
    for p in (pd_, fresh):
        h = p.round_to_hardcalls()
        assert isinstance(h, pt.GenoPack)
        assert np.array_equal(h.packed, jh.packed) and h.n == jh.n


def test_dpk_store_both_directions(packs, tmp_path):
    """A .dpk written by each package reads back in the other; codes.bin,
    code256.npy and meta.json are byte-equal."""
    jd, pd_ = packs
    jpath = jd.save(tmp_path / "jax")
    ppath = pd_.save(tmp_path / "port")
    for f in ("codes.bin", "code256.npy", "meta.json"):
        assert (tmp_path / "jax.dpk" / f).read_bytes() == \
            (tmp_path / "port.dpk" / f).read_bytes(), f
    for mmap in (True, False):
        a = pt.DosagePack.load(jpath, mmap=mmap)
        assert np.array_equal(np.asarray(a.codes), jd.codes)
        assert np.array_equal(a.code256, jd.code256, equal_nan=True)
        same_columns(a.map, jd.map)
        same_columns(a.fam, jd.fam)
    b = JaxDosagePack.load(ppath, mmap=False)
    assert np.array_equal(b.codes, jd.codes)
    same_columns(b.map, jd.map)
    same_columns(b.fam, jd.fam)
    bare = pt.DosagePack(codes=pd_.codes, n=pd_.n)
    back = pt.DosagePack.load(bare.save(tmp_path / "bare"))
    assert back.map is None and np.array_equal(back.codes, pd_.codes)


def test_interop(packs):
    jd, pd_ = packs
    assert np.array_equal(pd_.codes, jd.codes) and pd_.n == jd.n
    assert np.array_equal(pd_.code256, pcodes.CODE_DOSAGE, equal_nan=True)
    own = interop.dosage_from_numpy(jd.codes, jd.n,
                                    code256=jcodes.CODE_IMPUTE_PRED)
    assert np.array_equal(own.code256, jcodes.CODE_IMPUTE_PRED,
                          equal_nan=True)
    with pytest.raises(ValueError):
        interop.dosage_from_numpy(jd.codes, jd.n + 1)


def test_colstats_and_maf(packs):
    jd, pd_ = packs
    rows = np.arange(0, 150, 3)
    for ir in (None, rows):
        a, b = bt.snp_colstats(jd, ind_row=ir), pt.snp_colstats(pd_,
                                                                ind_row=ir)
        assert np.array_equal(a["nona"], b["nona"])
        for k in ("sumX", "denoX"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(pt.snp_MAF(pd_, ind_row=ir),
                                   bt.snp_MAF(jd, ind_row=ir), rtol=1e-12)
    sj, sp = bt.snp_scaleBinom(2)(jd), pt.snp_scaleBinom(2)(pd_)
    for k in ("center", "scale"):
        np.testing.assert_allclose(sp[k], sj[k], rtol=1e-12)


@pytest.mark.parametrize("l", [1, 3])
def test_byte_products(packs, l):
    """snp_cprodVec / snp_prodVec on the byte path: standardized and on the
    dosage scale (center 0, scale 1)."""
    jd, pd_ = packs
    rng = np.random.default_rng(l)
    sc = bt.snp_scaleBinom(2)(jd)
    v = rng.standard_normal((jd.n, l)).squeeze()
    u = rng.standard_normal((jd.m, l)).squeeze()
    for c, s in ((sc["center"], sc["scale"]), (None, None)):
        for fj, fp, w in ((bt.snp_cprodVec, pt.snp_cprodVec, v),
                          (bt.snp_prodVec, pt.snp_prodVec, u)):
            a = np.asarray(fj(jd, w, c, s))
            b = fp(pd_, w, c, s)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    with pytest.raises(ValueError):
        pt.snp_prodVec(pd_, np.ones(jd.m + 1))


def structured_codes(seed=9, m=200, n=240):
    """Byte codes of imputed-like dosages of 3 populations (so that the
    leading singular values stand apart and both solvers converge), 3% NA."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, n)
    p = np.clip(rng.uniform(0.1, 0.5, m)[:, None]
                + rng.normal(0, 0.15, (m, 3)), 0.02, 0.98)
    x = rng.binomial(2, p[:, pop]) + rng.uniform(-0.3, 0.3, (m, n))
    codes = (7 + np.round(100 * np.clip(x, 0, 2))).astype(np.uint8)
    codes[rng.random((m, n)) < 0.03] = 3
    return codes


def test_randomsvd():
    """d within 1e-4 of the JAX package's and of the exact SVD."""
    codes = structured_codes()
    m, n = codes.shape
    jd = JaxDosagePack(codes=codes, n=n)
    pd_ = interop.dosage_from_numpy(codes, n)
    kw = dict(k=3, tol=1e-6)
    rows, cols = np.arange(0, n, 2), np.arange(5, m)
    for sub in (dict(), dict(ind_row=rows, ind_col=cols)):
        a = bt.snp_randomSVD(jd, fun_scaling=bt.snp_scaleBinom(2), **sub,
                             **kw)
        b = pt.snp_randomSVD(pd_, fun_scaling=pt.snp_scaleBinom(2), **sub,
                             **kw)
        np.testing.assert_allclose(b.d, a.d, rtol=1e-4)
        np.testing.assert_allclose(b.center, a.center, rtol=1e-12)
        X = jd.subset(ind_row=sub.get("ind_row"),
                      ind_col=sub.get("ind_col")).to_dosage()
        Xt = np.nan_to_num((X - b.center) / b.scale)
        exact = np.linalg.svd(Xt, compute_uv=False)[:3]
        np.testing.assert_allclose(b.d, exact, rtol=1e-4)
        assert b.u.shape == (X.shape[0], 3) and b.v.shape == (X.shape[1], 3)


@pytest.mark.parametrize("finalize", ["host", "device"])
def test_snp_cor(packs, finalize):
    jd, pd_ = packs
    rows = np.arange(1, 150, 2)
    for kw in (dict(size=12), dict(size=12, ind_row=rows, thr_r2=0.005,
                                   alpha=0.5)):
        a = bt.snp_cor(jd, **kw).to_dense()
        b = pt.snp_cor(pd_, finalize=finalize, **kw).to_dense()
        assert np.array_equal(a != 0, b != 0)
        assert np.abs(a - b).max() <= 1e-5


def test_byte_blocks_chunked(packs, monkeypatch):
    """The three byte-path sites split into many decode blocks (one block
    rule, `blocks.byte_rows`, cut to 600 entries): colstats and the byte
    products over blocks of 4 variants, snp_cor's pair sums over chunks of
    samples; each against the JAX package at the tolerances above."""
    from bigsnpr_tpu_torch.ops import blocks

    jd, pd_ = packs
    monkeypatch.setattr(blocks, "BYTE_ENTRIES", 600)
    assert blocks.byte_rows(jd.n) == 4
    a, b = bt.snp_colstats(jd), pt.snp_colstats(pd_)
    assert np.array_equal(a["nona"], b["nona"])
    np.testing.assert_allclose(b["denoX"], a["denoX"], rtol=1e-12)
    sc = bt.snp_scaleBinom(2)(jd)
    rng = np.random.default_rng(4)
    for fj, fp, w in ((bt.snp_cprodVec, pt.snp_cprodVec,
                       rng.standard_normal((jd.n, 2))),
                      (bt.snp_prodVec, pt.snp_prodVec,
                       rng.standard_normal((jd.m, 2)))):
        x = np.asarray(fj(jd, w, sc["center"], sc["scale"]))
        y = fp(pd_, w, sc["center"], sc["scale"])
        assert np.abs(x - y).max() <= 1e-5 * np.abs(x).max()
    a = bt.snp_cor(jd, size=12).to_dense()
    b = pt.snp_cor(pd_, size=12).to_dense()
    assert np.array_equal(a != 0, b != 0)
    assert np.abs(a - b).max() <= 1e-5


def test_ld_scores(packs):
    jd, pd_ = packs
    a = bt.snp_ld_scores(jd, size=12)
    b = pt.snp_ld_scores(pd_, size=12)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_clumping(packs):
    jd, pd_ = packs
    m = jd.m
    chrs = np.repeat([1, 2], m // 2)
    S = np.random.default_rng(3).random(m)
    for kw in (dict(thr_r2=0.05), dict(thr_r2=0.02, S=S),
               dict(thr_r2=0.03, ind_row=np.arange(100), exclude=[3, 9])):
        a = bt.snp_clumping(jd, infos_chr=chrs, **kw)
        b = pt.snp_clumping(pd_, infos_chr=chrs, **kw)
        assert np.array_equal(a, b)


def test_grid_clumping(packs):
    """Each grid cell's keep set equals the JAX package's snp_clumping at
    that cell's (thr_r2, base_size / thr_r2) on its rank statistic lpS.
    (The JAX package's own snp_grid_clumping reads `sub.packed` and raises
    on a DosagePack: port DEVIATIONS #27.)"""
    jd, pd_ = packs
    m = jd.m
    chrs = np.repeat([1, 2], m // 2)
    pos = np.r_[np.arange(1, m // 2 + 1), np.arange(1, m // 2 + 1)] * 1000
    lpS = np.random.default_rng(4).random(m) * 5
    thrs, bases = (0.02, 0.05), (3, 8)
    with pytest.raises(AttributeError):
        bt.snp_grid_clumping(jd, chrs, pos, lpS, grid_thr_r2=thrs,
                             grid_base_size=bases)
    keep, grid = pt.snp_grid_clumping(pd_, chrs, pos, lpS,
                                      grid_thr_r2=thrs, grid_base_size=bases)
    for c in (1, 2):
        for cell, (thr, base) in enumerate((t, b) for t in thrs
                                           for b in bases):
            ind = np.flatnonzero(chrs == c)
            ref = jclump.snp_clumping(jd, infos_chr=chrs, S=lpS, thr_r2=thr,
                                      size=base / thr, infos_pos=pos,
                                      exclude=np.flatnonzero(chrs != c))
            assert np.array_equal(np.sort(keep[c][cell]), ref), (c, cell)
            assert np.isin(keep[c][cell], ind).all()
    assert list(grid["thr.r2"]) == [0.02, 0.02, 0.05, 0.05]


def test_grid_prs_and_prs(packs):
    """snp_PRS and snp_grid_PRS on a DosagePack score through the byte
    path (no genotype kernel), equal to the JAX package's within 1e-5."""
    jd, pd_ = packs
    rng = np.random.default_rng(5)
    betas = rng.standard_normal(jd.m)
    lpS = rng.random(jd.m) * 4
    test = np.arange(0, 150, 5)
    thr = [0.0, 1.0, 2.5]
    a = bt.snp_PRS(jd, betas, ind_test=test, lpS_keep=lpS, thr_list=thr)
    b = pt.snp_PRS(pd_, betas, ind_test=test, lpS_keep=lpS, thr_list=thr)
    assert np.abs(np.asarray(a) - b).max() <= 1e-5 * np.abs(a).max()
    keep = {1: [np.arange(0, 30, 2), np.arange(30)], 2: [np.arange(30, 60)]}
    g = pt.snp_grid_PRS(pd_, keep, betas, lpS, grid_lpS_thr=np.array(thr),
                        ind_row=test)
    for ci, ks in enumerate([keep[1][0], keep[1][1], keep[2][0]]):
        ref = np.asarray(bt.snp_prodVec(
            jd.subset(ind_row=test),
            np.where(np.isin(np.arange(jd.m), ks)[:, None]
                     & (lpS[:, None] > np.array(thr)[None, :]),
                     betas[:, None], 0.0)))
        got = g.scores[:, 3 * ci:3 * ci + 3]
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_dosage_entry_points_raise_without_cuda(packs):
    """The device rule on a DosagePack: with no CUDA device and no request
    for the CPU, every byte-path entry point raises; asked, it runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, pd_ = packs
    fresh = interop.dosage_from_numpy(pd_.codes, pd_.n)
    with pt.config.options(device="cuda"):
        for call in (lambda: pt.snp_colstats(fresh),
                     lambda: pt.snp_prodVec(fresh, np.ones(fresh.m)),
                     lambda: pt.snp_cprodVec(fresh, np.ones(fresh.n)),
                     lambda: pt.snp_randomSVD(fresh, k=2),
                     lambda: pt.snp_cor(fresh, size=5),
                     lambda: pt.snp_ld_scores(fresh, size=5),
                     lambda: fresh.subset(ind_row=[0, 1], device="cuda"),
                     lambda: fresh.device_codes()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert pt.snp_colstats(fresh, device="cpu")["nona"].shape == (fresh.m,)
