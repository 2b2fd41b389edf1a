"""Port parity: the GRM (`ops/grm.py`) and the small statistics.

`bed_tcrossprodSelf` / `bed_GRM` (a float32 GEMM update on device-decoded
blocks in the port, an XLA scan in the JAX package) against the JAX
package's at float32 round-off (2e-6 of max |K|) and against a float64
oracle at tests/test_grm_ancestry.py::test_tcrossprod_oracle's bound;
`snp_MAX3` (counts from the port's `snp_counts`), `snp_fst`,
`snp_ancestry_summary` and `snp_scaleAlpha` (host copies) against the
JAX functions to 1e-12; the plots' axes as in
tests/test_plots_penalized.py; the `utils/misc` helpers and the raising
downloads."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.assoc import fst as jfst
from bigsnpr_tpu.assoc import max3 as jmax3
from bigsnpr_tpu.assoc import mhtest as jmh
from bigsnpr_tpu.ops import grm as jgrm
from bigsnpr_tpu.ops import stats as jstats
from bigsnpr_tpu.pca import ancestry as janc
from bigsnpr_tpu.utils import misc as jmisc
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def packs(n, m, seed, na_prob=0.04):
    jp = bt.snp_fake(n, m, seed=seed, na_prob=na_prob)
    return jp, interop.pack_from_numpy(np.asarray(jp.packed), n, fam=jp.fam,
                                       map=jp.map)


def dense_standardized(pack, center, scale):
    X = pack.to_dosage()
    return np.nan_to_num((X - center) / scale)


@pytest.mark.parametrize("n,m,block", [(70, 150, None), (133, 411, 64)])
def test_tcrossprod_and_grm_match_jax(n, m, block):
    jp, pp = packs(n, m, seed=51)
    # a monomorphic variant: scale 0 -> 1, as in the JAX package
    codes = bt.core.unpack.np_unpack_codes(np.asarray(jp.packed), n).copy()
    codes[3] = 0
    jp.packed = bt.core.unpack.np_pack_codes(codes)
    pp = interop.pack_from_numpy(np.asarray(jp.packed), n)
    K, c, s = pt.bed_tcrossprodSelf(pp, block=block)
    Kj, cj, sj = jgrm.bed_tcrossprodSelf(jp, block=block)
    assert K.dtype == np.float64 and s[3] == 0
    np.testing.assert_allclose(c, cj, rtol=1e-12)
    np.testing.assert_allclose(s, sj, rtol=1e-12)
    assert np.abs(K - Kj).max() <= 2e-6 * np.abs(Kj).max()
    Xt = dense_standardized(jp, cj, np.where(sj > 0, sj, 1))
    np.testing.assert_allclose(K, Xt @ Xt.T, rtol=2e-4, atol=2e-3)
    assert np.array_equal(K, K.T)
    G = pt.bed_GRM(pp, block=block)
    np.testing.assert_allclose(G, K / m, rtol=1e-12)
    rows, cols = np.arange(0, n, 2), np.arange(1, m, 3)
    Ks, _, _ = pt.bed_tcrossprodSelf(pp, ind_row=rows, ind_col=cols)
    Kjs, _, _ = jgrm.bed_tcrossprodSelf(jp, ind_row=rows, ind_col=cols)
    assert np.abs(Ks - Kjs).max() <= 2e-6 * np.abs(Kjs).max()


def test_scale_alpha_matches_jax():
    jp, pp = packs(91, 60, seed=3)
    for alpha in (-1.0, 0.0, -0.5):
        a = pt.snp_scaleAlpha(alpha)(pp)
        b = jstats.snp_scaleAlpha(alpha)(jp)
        for k in ("center", "scale"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12)
    a = pt.snp_scaleAlpha()(pp, ind_row=np.arange(0, 91, 3))
    b = jstats.snp_scaleAlpha()(jp, ind_row=np.arange(0, 91, 3))
    np.testing.assert_allclose(a["scale"], b["scale"], rtol=1e-12)


@pytest.mark.parametrize("val", [(0, 0.5, 1), (0.5,)])
def test_max3_matches_jax(val):
    jp, pp = packs(400, 200, seed=33, na_prob=0.0)
    rng = np.random.default_rng(2)
    X = jp.to_dosage()
    logits = (X[:, 0] >= 1) * 1.5 - 0.5
    y01 = (rng.random(400) < 1 / (1 + np.exp(-logits))).astype(int)
    a = pt.snp_MAX3(pp, y01, val=val)
    b = jmax3.snp_MAX3(jp, y01, val=val)
    np.testing.assert_allclose(a.score, b.score, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a.lpval(), b.lpval(), rtol=1e-12, atol=1e-12)
    if len(val) == 3:
        assert a.score[0] > np.quantile(a.score[1:], 0.99)
    train = np.arange(0, 400, 2)
    a = pt.snp_MAX3(pp, y01[train], ind_train=train, val=val)
    b = jmax3.snp_MAX3(jp, y01[train], ind_train=train, val=val)
    np.testing.assert_allclose(a.score, b.score, rtol=1e-12, atol=1e-12)


def test_fst_matches_jax():
    rng = np.random.default_rng(3)
    m = 500
    p_anc = rng.uniform(0.2, 0.8, m)
    a, b = p_anc * 9, (1 - p_anc) * 9
    tables = []
    for N in (400, 250, 300):
        p = rng.beta(a, b)
        tables.append({"af": rng.binomial(2 * N, p) / (2 * N),
                       "N": np.full(m, N)})
    for kw in ({}, {"overall": True}, {"min_maf": 0.1},
               {"min_maf": 0.1, "overall": True}):
        x, y = pt.snp_fst(tables, **kw), jfst.snp_fst(tables, **kw)
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-15)
    _, pp = packs(120, 80, seed=8)
    pops = [np.arange(0, 60), np.arange(60, 120)]
    maf = [pt.bed_MAF(pp, ind_row=r) for r in pops]
    assert np.isfinite(pt.snp_fst(maf, overall=True))
    with pytest.raises(ValueError):
        pt.snp_fst(tables[:1])


def test_ancestry_summary_matches_jax():
    rng = np.random.default_rng(6)
    m, npop = 2000, 4
    ref_freq = rng.uniform(0.05, 0.95, (m, npop))
    w_true = np.array([0.5, 0.3, 0.2, 0.0])
    freq = np.clip(ref_freq @ w_true + rng.normal(0, 0.002, m), 0, 1)
    U, _, _ = np.linalg.svd(ref_freq - ref_freq.mean(axis=0),
                            full_matrices=False)
    P, corr = U[:, :npop], np.ones(npop)
    for kw in ({}, {"sum_to_one": False}):
        a, ia = pt.snp_ancestry_summary(freq, ref_freq, P, corr, **kw)
        b, ib = janc.snp_ancestry_summary(freq, ref_freq, P, corr, **kw)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ia["cor_each"], ib["cor_each"],
                                   rtol=1e-12)
        assert abs(ia["cor_pred"] - ib["cor_pred"]) <= 1e-12
    np.testing.assert_allclose(a, w_true, atol=0.02)
    with pytest.raises(ValueError, match="reversed"):
        pt.snp_ancestry_summary(1 - freq, ref_freq, P, corr)


def test_plots_axes():
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    m = 500
    score = rng.chisquare(1, m)
    gwas = pt.MHTest(score=score, predict=jmh.chisq_log10_predictor(1))
    jg = jmh.MHTest(score=score, predict=jmh.chisq_log10_predictor(1))
    ax, axj = pt.snp_qq(gwas), jmh.snp_qq(jg)
    assert ax.get_title() == axj.get_title()
    assert ax.get_title().startswith("Q-Q")
    assert np.array_equal(ax.lines[0].get_ydata(), axj.lines[0].get_ydata())
    chrs = np.repeat([1, 2, 3, 4, 5], m // 5)
    pos = np.tile(np.arange(m // 5) * 1e4, 5)
    ax2 = pt.snp_manhattan(gwas, chrs, pos, ind_highlight=[3, 7], npoints=300)
    ax2j = jmh.snp_manhattan(jg, chrs, pos, ind_highlight=[3, 7],
                             npoints=300)
    assert len(ax2.collections) == 1
    assert np.array_equal(ax2.collections[0].get_offsets(),
                          ax2j.collections[0].get_offsets())
    assert [t.get_text() for t in ax2.get_xticklabels()] == \
        [t.get_text() for t in ax2j.get_xticklabels()]
    plt.close("all")


def test_misc_helpers(tmp_path):
    assert pt.sub_bed("a/b.bed", ".bim") == jmisc.sub_bed("a/b.bed", ".bim")
    assert pt.sub_bed("a/b", ".x", stop_if_not_ext=False) == "a/b.x"
    with pytest.raises(ValueError):
        pt.sub_bed("a/b.txt")
    A = sp.random(30, 30, density=0.2, random_state=2)
    S = (A + A.T).tocsc()
    got, ref = pt.as_SFBM(S), jmisc.as_SFBM(S)
    assert (got.upper != ref.upper).nnz == 0
    assert pt.as_SFBM(got) is got
    # per-chromosome split-apply, longest chromosome first
    chrs = np.array([2, 1, 1, 3, 2, 1, 3, 3, 3])

    def fun(ind_chr, chr, scale=1):
        return {"chr": np.full(len(ind_chr), chr), "i": ind_chr * scale}

    for combine in (None, "rbind"):
        a = pt.snp_split(chrs, fun, combine=combine, scale=2)
        b = jmisc.snp_split(chrs, fun, combine=combine, scale=2)
        if combine is None:
            for x, y in zip(a, b):
                assert all(np.array_equal(x[k], y[k]) for k in x)
        else:
            assert all(np.array_equal(a[k], b[k].to_numpy()) for k in a)
    vals = lambda ind_chr, chr: ind_chr + 100  # noqa: E731
    assert np.array_equal(pt.snp_split(chrs, vals, combine="c", ncores=2),
                          jmisc.snp_split(chrs, vals, combine="c"))
    add = lambda x, y: x + y.sum()  # noqa: E731
    assert np.array_equal(pt.snp_split(chrs, vals, combine=add),
                          jmisc.snp_split(chrs, vals, combine=add))
    with pytest.raises(RuntimeError):
        pt.snp_pruning()
    with pytest.raises(RuntimeError):
        pt.download_1000G(str(tmp_path))
    with pytest.raises(RuntimeError):
        pt.download_genetic_map()
    with pytest.raises(FileNotFoundError):
        pt.snp_attachExtdata("no-such-file.bed")


def test_sample_infos_match_jax(tmp_path):
    jp, pp = packs(12, 5, seed=4)
    fam = jp.fam
    order = [3, 0, 7, 1, 11, 2, 5, 9, 4]          # 3 samples unmatched
    info = pd.DataFrame({"FID": fam["family.ID"].to_numpy()[order],
                         "IID": fam["sample.ID"].to_numpy()[order],
                         "age": np.arange(40, 49),
                         "pop": [f"P{i % 3}" for i in range(9)],
                         "h": 1.5 + 0.125 * np.arange(9)})
    f1, f2 = tmp_path / "a.txt", tmp_path / "b.txt"
    for f, part in ((f1, info.iloc[:5]), (f2, info.iloc[5:])):
        part.to_csv(f, sep=" ", index=False)
    with pytest.warns(UserWarning, match="3 individuals"):
        got = pt.snp_getSampleInfos(pp, [str(f1), str(f2)])
    with pytest.warns(UserWarning):
        ref = jmisc.snp_getSampleInfos(jp, [str(f1), str(f2)])
    assert list(got) == list(ref.columns)
    for c in ref.columns:
        a, b = got[c], ref[c].to_numpy()
        assert [str(x) for x in a] == [str(x) for x in b], c
    with pytest.warns(UserWarning):
        got2 = pt.snp_getSampleInfos(pp, {k: info[k].to_numpy()
                                          for k in info}, col_infos=[2])
    assert list(got2) == ["age"]
    assert np.isnan(got2["age"][6]) and got2["age"][0] == 41


def test_trace_writes_a_chrome_trace(tmp_path):
    """`trace` (torch.profiler) around a port call: the profiler's table
    holds the call's ops and `trace.json` is written."""
    _, pp = packs(50, 40, seed=9)
    with pt.trace(str(tmp_path / "tr")) as prof:
        pt.bed_GRM(pp)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("addmm" in e.key for e in prof.key_averages())
