"""Slice 6 end to end: the chain of chip_smoke.py [18] at a small size
through both packages (snp_match -> bed_projectPCA -> the .gpk store ->
bed_GRM -> MAX3 / Fst / ancestry / genetic positions), each stage held
against the JAX package's at the tolerance of its parity test; and the
same chain, then slice 6c's (chip_smoke.py [19] at a small size), in a
subprocess with jax, pandas, pyarrow and bigsnpr_tpu blocked. Kept apart
from test_torch_slice.py so that `--dist loadfile` gives it another
worker."""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.assoc import fst as jfst
from bigsnpr_tpu.assoc import max3 as jmax3
from bigsnpr_tpu.core import genotypes as jg
from bigsnpr_tpu.core import unpack as ju
from bigsnpr_tpu.ops import grm as jgrm
from bigsnpr_tpu.pca import ancestry as janc
from bigsnpr_tpu.pca import project as jproj
from bigsnpr_tpu.utils import match as jm
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from test_torch_match import assert_same_table

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV2 = {**os.environ, "OMP_NUM_THREADS": "2"}


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def cohort(seed=6, n_ref=200, n_t=160, m=600):
    """A reference and a target (JAX packs with DataFrame maps) made as
    chip_smoke.py [18] makes them: 2 chromosomes, alleles from the
    non-ambiguous pairs with 2% ambiguous; the target drops 5% of the
    variants, reverses 10% (genotypes 2 - x), strand-flips 5%."""
    rng = np.random.default_rng(seed)
    pack = bt.snp_fake(n_ref + n_t, m, seed=seed, na_prob=0.01)
    pairs = np.array([("A", "C"), ("A", "G"), ("C", "T"), ("G", "T"),
                      ("T", "C"), ("G", "A")])
    al = pairs[rng.integers(0, len(pairs), m)]
    amb = rng.random(m) < 0.02
    al[amb] = ("A", "T")
    chrs = np.repeat([1, 2], m // 2)
    pos = np.concatenate([np.cumsum(rng.integers(1, 5000, m // 2))] * 2)
    ref_map = pd.DataFrame({"chromosome": chrs,
                            "marker.ID": [f"rs{j}" for j in range(m)],
                            "genetic.dist": 0.0, "physical.pos": pos,
                            "allele1": al[:, 0], "allele2": al[:, 1]})
    ref = pack.subset(ind_row=np.arange(n_ref))
    ref.map = ref_map
    kept = np.flatnonzero(rng.random(m) >= 0.05)
    rev = rng.random(len(kept)) < 0.1
    flip = (~rev) & (~amb[kept]) & (rng.random(len(kept)) < 0.06)
    tgt = pack.subset(ind_row=np.arange(n_ref, n_ref + n_t), ind_col=kept)
    X = tgt.to_dosage()
    Xr = np.where(rev[None, :], 2 - X, X)
    comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
    a1, a2 = al[kept, 0].copy(), al[kept, 1].copy()
    a1[rev], a2[rev] = al[kept, 1][rev], al[kept, 0][rev]
    for a in (a1, a2):
        a[flip] = [comp[x] for x in a[flip]]
    t_map = ref_map.iloc[kept].reset_index(drop=True)
    t_map["allele1"], t_map["allele2"] = a1, a2
    t_rev = jg.GenoPack(packed=ju.np_pack_codes(ju.np_dosage_to_codes(Xr.T)),
                        n=n_t, fam=tgt.fam, map=t_map)
    pop = rng.integers(0, 3, n_ref + n_t)
    return ref, tgt, t_rev, kept, pop


def port_pack(p):
    return interop.pack_from_numpy(np.asarray(p.packed), p.n, fam=p.fam,
                                   map=p.map)


def test_slice6_chain_matches_jax(tmp_path):
    ref, tgt, t_rev, kept, pop = cohort()
    pref, ptgt, prev = port_pack(ref), port_pack(tgt), port_pack(t_rev)
    # snp_match: the target's map as sumstats against the reference map
    rng = np.random.default_rng(1)
    tm, rm = t_rev.map, ref.map
    ss = pd.DataFrame({"chr": tm["chromosome"], "pos": tm["physical.pos"],
                       "a0": tm["allele2"], "a1": tm["allele1"],
                       "beta": rng.standard_normal(len(tm))})
    info = pd.DataFrame({"chr": rm["chromosome"], "pos": rm["physical.pos"],
                         "a0": rm["allele2"], "a1": rm["allele1"],
                         "rsid": rm["marker.ID"]})
    jmatch = jm.snp_match(ss, info, return_flip_and_rev=True, verbose=False)
    pmatch = pt.snp_match({k: ss[k].to_numpy() for k in ss},
                          {k: info[k].to_numpy() for k in info},
                          return_flip_and_rev=True, verbose=False)
    assert_same_table(pmatch, jmatch)
    # bed_projectPCA of the reversed target
    kw = dict(k=4, thr_r2=0.5, min_mac=2, min_maf=0.01, max_iter=2)
    jres = jproj.bed_projectPCA(ref, t_rev, **kw)
    pres = pt.bed_projectPCA(pref, prev, **kw)
    obj = pres["obj.svd.ref"]
    assert np.array_equal(obj.subset, jres["obj.svd.ref"].subset)
    for key in ("simple_proj", "OADP_proj"):
        b = np.asarray(jres[key])
        np.testing.assert_allclose(pres[key], b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    # the store, both ways
    pstore = prev.save(tmp_path / "port")
    jstore = t_rev.save(tmp_path / "jax")
    assert np.array_equal(np.asarray(jg.snp_attach(pstore).packed),
                          np.asarray(pt.snp_attach(jstore).packed))
    back = pt.snp_attach(jstore)
    assert np.array_equal(np.asarray(back.packed), np.asarray(t_rev.packed))
    assert_same_table(back.map, t_rev.map)
    # the GRM of the target
    K = pt.bed_GRM(ptgt)
    Kj = jgrm.bed_GRM(tgt)
    assert np.abs(K - Kj).max() <= 2e-6 * np.abs(Kj).max()
    # MAX3, Fst, ancestry on the target and the reference
    X = tgt.to_dosage()
    j = int(np.nanargmax(np.nanvar(X, axis=0)))
    d = np.nan_to_num(X[:, j] - np.nanmean(X[:, j]))
    y01 = (rng.random(tgt.n) < 1 / (1 + np.exp(-2 * d))).astype(int)
    a, b = pt.snp_MAX3(ptgt, y01), jmax3.snp_MAX3(tgt, y01)
    np.testing.assert_allclose(a.score, b.score, rtol=1e-12, atol=1e-12)
    pop_t, pop_r = pop[ref.n:], pop[:ref.n]
    tabs = [pt.bed_MAF(ptgt, ind_row=np.flatnonzero(pop_t == k))
            for k in range(3)]
    jtabs = [bt.bed_MAF(tgt, ind_row=np.flatnonzero(pop_t == k))
             for k in range(3)]
    assert abs(pt.snp_fst(tabs, overall=True)
               - jfst.snp_fst(jtabs, overall=True)) <= 1e-12
    at = np.full(ref.m, -1)
    at[kept] = np.arange(len(kept))
    cols = at[obj.subset]
    X0 = np.column_stack([pt.bed_MAF(pref, ind_row=np.flatnonzero(
        pop_r == k))["af"][obj.subset] for k in range(3)])
    freq = np.column_stack([t["af"][cols] for t in tabs]) @ [0.6, 0.3, 0.1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol, _ = pt.snp_ancestry_summary(freq, X0, obj.v, np.ones(4),
                                         min_cor=0.0)
        jsol, _ = janc.snp_ancestry_summary(freq, X0, obj.v, np.ones(4),
                                            min_cor=0.0)
    np.testing.assert_allclose(sol, jsol, rtol=1e-12, atol=1e-12)
    cm = pt.snp_asGeneticPos(rm["chromosome"], rm["physical.pos"],
                             {"chr": rm["chromosome"].to_numpy(),
                              "pos": rm["physical.pos"].to_numpy(),
                              "pos_cM": np.arange(ref.m) / 100.0})
    assert np.array_equal(cm, np.arange(ref.m) / 100.0)


# The chip path of slice 6 with jax, pandas, pyarrow and the JAX package
# blocked (a finder that raises; see test_torch_slice.py).
SCRIPT6 = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "pyarrow", "bigsnpr_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import bigsnpr_tpu_torch as pt

    pt.config.set_device("cpu")
    rng = np.random.default_rng(0)
    full = pt.snp_fake(300, 400, seed=2)
    m = full.m
    al = np.array([("A", "C"), ("A", "G"), ("C", "T"), ("G", "T")])[
        rng.integers(0, 4, m)]
    full.map["allele1"], full.map["allele2"] = al[:, 0], al[:, 1]
    ref = full.subset(ind_row=np.arange(200))
    tgt = full.subset(ind_row=np.arange(200, 300))
    mp = ref.map
    info = {"chr": mp["chromosome"], "pos": mp["physical.pos"],
            "a0": mp["allele2"], "a1": mp["allele1"], "rsid": mp["marker.ID"]}
    ss = dict(info, beta=rng.standard_normal(m))
    out = pt.snp_match(ss, info, verbose=False)
    assert len(out["beta"]) == m
    res = pt.bed_projectPCA(ref, tgt, k=3, thr_r2=0.5, min_mac=2,
                            min_maf=0.01, max_iter=1)
    assert np.isfinite(res["OADP_proj"]).all()
    bare = pt.GenoPack(packed=tgt.packed, n=tgt.n)
    back = pt.snp_attach(bare.save(sys.argv[2] + "/t"))
    assert np.array_equal(np.asarray(back.packed), tgt.packed)
    G = pt.bed_GRM(tgt)
    assert G.shape == (100, 100) and np.isfinite(G).all()
    y01 = rng.integers(0, 2, 100)
    assert pt.snp_MAX3(tgt, y01).score.shape == (m,)
    tabs = [pt.bed_MAF(tgt, ind_row=np.arange(k, 100, 2)) for k in (0, 1)]
    assert np.isfinite(pt.snp_fst(tabs, overall=True))
    P = np.linalg.qr(rng.standard_normal((m, 2)))[0]
    F = rng.uniform(0.1, 0.9, (m, 2))
    sol, _ = pt.snp_ancestry_summary(F @ [0.7, 0.3], F, P, np.ones(2))
    assert abs(sol.sum() - 1) < 1e-6
    cm = pt.snp_asGeneticPos(mp["chromosome"], mp["physical.pos"])
    assert np.all(np.diff(cm) >= 0)
    assert pt.snp_scaleAlpha()(tgt)["scale"].shape == (m,)
    both = pt.snp_split(mp["chromosome"], lambda ind_chr, chr: {
        "i": ind_chr}, combine="rbind")
    assert len(both["i"]) == m
    # slice 6c: chip_smoke.py [19] at a small size (BGEN written and read,
    # the byte path through QC, PCA, LD, LDpred2-grid, C+T, snp_prodBGEN,
    # hard calls, the .dpk store and warmup)
    import chip_smoke as cs
    from bigsnpr_tpu_torch.ops import geno_kernels as gk
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    args = cs.arg_parser().parse_args(
        ["--n7", "300", "--m7", "1500", "--bmin", "60", "--bmax", "150",
         "--burn-in", "3", "--num-iter", "3"])
    dev = torch.device("cpu")
    cs.phase_slice6c(pt, gk, gsk, torch, dev, args, cs.Timer(torch, dev))
    bad = [x for x in sys.modules if x.split(".")[0] in BLOCKED]
    assert not bad, bad
    print("SLICE6-PORT-ONLY-OK")
""")


def test_slice6_runs_without_jax_pandas_or_pyarrow(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT6, REPO, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=ENV2)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SLICE6-PORT-ONLY-OK" in out.stdout
