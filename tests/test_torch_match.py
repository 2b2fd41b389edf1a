"""Port parity: allele matching (`utils/match.py`).

`snp_match` of the port (dicts of numpy columns, a numpy join) against the
JAX package's (pandas frames, an inner merge) on the same tables: the
rows, their order, the column names (with the merge's ".ss" suffix) and
`_NUM_ID_` equal, every value equal (floats bit for bit). `same_ref` and
`snp_asGeneticPos(2)` equal too."""

import numpy as np
import pandas as pd
import pytest
import torch

from bigsnpr_tpu.utils import match as jm
from bigsnpr_tpu_torch.utils import match as pm

torch.set_num_threads(2)


def assert_same_table(port: dict, ref: pd.DataFrame):
    assert list(port) == list(ref.columns)
    for c in ref.columns:
        a, b = np.asarray(port[c]), ref[c].to_numpy()
        assert len(a) == len(b), c
        if b.dtype.kind == "f":
            assert np.array_equal(a.astype(np.float64), b, equal_nan=True), c
        else:
            assert [str(x) for x in a] == [str(x) for x in b], c


@pytest.fixture
def match_frames():
    """The frames of tests/test_assoc_match.py (the reference's
    test-5-match.R example)."""
    sumstats = pd.DataFrame({
        "chr": [1, 1, 1, 1, 1, 1],
        "pos": [86303, 86331, 162463, 752566, 755890, 758144],
        "a0": ["T", "G", "C", "A", "T", "G"],
        "a1": ["G", "A", "T", "G", "A", "A"],
        "beta": [-1.868, 0.250, -0.671, 2.112, 0.239, 1.272],
        "p": [0.860, 0.346, 0.900, 0.456, 0.776, 0.383],
    })
    info_snp = pd.DataFrame({
        "chr": 1,
        "rsid": ["rs2949417", "rs115209712", "rs143399298", "rs3094315",
                 "rs3115858"],
        "a0": ["T", "A", "G", "A", "T"],
        "a1": ["G", "G", "A", "G", "A"],
        "pos": [86303, 86331, 162463, 752566, 755890],
    })
    return sumstats, info_snp


def both(sumstats, info, **kw):
    ref = jm.snp_match(sumstats, info, verbose=False, **kw)
    port = pm.snp_match({k: sumstats[k].to_numpy() for k in sumstats},
                        {k: info[k].to_numpy() for k in info},
                        verbose=False, **kw)
    assert_same_table(port, ref)
    return port


@pytest.mark.parametrize("kw", [{}, {"strand_flip": False},
                                {"return_flip_and_rev": True}])
def test_reference_frames(match_frames, kw):
    sumstats, info = match_frames
    out = both(sumstats, info, **kw)
    assert len(out["beta"]) == 4


def test_by_rsid_and_duplicates(match_frames):
    sumstats, info = match_frames
    s2 = sumstats.copy()
    s2["rsid"] = ["rs2949417", "rs115209712", "rs143399298", "rs3094315",
                  "rs3115858", "rs0"]
    s2["pos"] = s2["pos"] + 10
    s2["beta"] = 1.0
    with pytest.raises(ValueError, match="No variant"):
        pm.snp_match({k: s2[k].to_numpy() for k in s2},
                     {k: info[k].to_numpy() for k in info}, verbose=False)
    out = both(s2, info, join_by_pos=False)
    assert "pos.ss" in out and "rsid" in out
    s3 = pd.concat([s2.iloc[[0]], s2], ignore_index=True)
    assert len(both(s3, info, join_by_pos=False)["beta"]) == 3
    both(s3, info, join_by_pos=False, remove_dups=False)
    with pytest.raises(ValueError, match="Not enough"):
        pm.snp_match({k: s3[k].to_numpy() for k in s3},
                     {k: info[k].to_numpy() for k in info},
                     join_by_pos=False, match_min_prop=0.9, verbose=False)


def seeded_tables(seed, n_info=5000, chr_kind="int"):
    """A 5,000-row info table over 3 chromosomes and sumstats made from it:
    reversed, strand-flipped and ambiguous rows, positions absent from the
    info table, a repeated info position with other alleles (a multi-match
    and a duplicate site), sumstats rows repeated, an indel, shuffled."""
    rng = np.random.default_rng(seed)
    pairs = np.array([("A", "C"), ("A", "G"), ("C", "T"), ("G", "T"),
                      ("A", "T"), ("C", "G")])
    chrs = np.sort(rng.integers(1, 4, n_info))
    pos = np.concatenate([np.sort(rng.choice(10 ** 7, (chrs == c).sum(),
                                             replace=False)) + 1
                          for c in (1, 2, 3)])
    al = pairs[rng.integers(0, 6, n_info)]
    info = {"chr": chrs, "pos": pos, "a0": al[:, 0].copy(),
            "a1": al[:, 1].copy(), "rsid": np.array([f"rs{i}" for i in
                                                     range(n_info)])}
    # one site twice with other alleles, one twice as it is (a multi-match)
    for k in info:
        info[k] = np.concatenate([info[k], info[k][[10, 20]]])
    info["a0"][-2], info["a1"][-2] = "AC", "A"
    info["rsid"][-2:] = "rs10b", "rs20b"
    n = len(info["chr"])
    take = np.concatenate([[20], rng.permutation(n)[:3999]])
    ss = {"chr": info["chr"][take], "pos": info["pos"][take].copy(),
          "a0": info["a0"][take].copy(), "a1": info["a1"][take].copy(),
          "rsid": info["rsid"][take].copy(),
          "beta": rng.standard_normal(4000),
          "beta_se": rng.uniform(0.01, 0.1, 4000)}
    rev = rng.random(4000) < 0.3
    ss["a0"][rev], ss["a1"][rev] = info["a1"][take][rev], info["a0"][take][rev]
    flip = rng.random(4000) < 0.2
    comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
    for a in ("a0", "a1"):
        ss[a][flip] = [comp.get(x, x) for x in ss[a][flip]]
    gone = rng.random(4000) < 0.1
    ss["pos"][gone] += 1
    dup = rng.integers(0, 4000, 50)
    for k in ss:
        ss[k] = np.concatenate([ss[k], ss[k][dup]])
    if chr_kind == "str":
        info["chr"] = np.array([str(c) if c < 3 else "X" for c in info["chr"]])
        ss["chr"] = np.array([str(c) if c < 3 else "X" for c in ss["chr"]])
    return pd.DataFrame(ss), pd.DataFrame(info)


@pytest.mark.parametrize("chr_kind", ["int", "str"])
@pytest.mark.parametrize("kw", [{}, {"remove_dups": False},
                                {"join_by_pos": False},
                                {"join_by_pos": False, "remove_dups": False,
                                 "return_flip_and_rev": True},
                                {"strand_flip": False,
                                 "return_flip_and_rev": True}])
def test_seeded_5000_rows(chr_kind, kw):
    ss, info = seeded_tables(11, chr_kind=chr_kind)
    out = both(ss, info, **kw)
    assert len(out["beta"]) > 2000


def test_same_ref_and_genetic_pos(match_frames):
    sumstats, info = match_frames
    args = (info["a1"], info["a0"], sumstats["a1"][:5], sumstats["a0"][:5])
    assert np.array_equal(pm.same_ref(*args), jm.same_ref(*args))
    args = (["A", "C", "T", "G", None], ["C", "T", "C", "A", "A"],
            ["A", "C", "A", "A", "C"], ["C", "G", "G", "G", "A"])
    assert np.array_equal(pm.same_ref(*args), jm.same_ref(*args),
                          equal_nan=True)
    rng = np.random.default_rng(3)
    gpos = np.sort(rng.choice(10 ** 6, 300, replace=False))
    gmap = {"chr": np.repeat([1, 2], 150), "pos": gpos,
            "pos_cM": np.cumsum(rng.uniform(0, 0.01, 300)),
            "rsid": np.array([f"rs{i}" for i in range(300)])}
    chrs = np.repeat([1, 2], 40)
    pos = rng.integers(0, 10 ** 6, 80)
    rsid = np.array([f"rs{i}" if i % 3 else "none" for i in range(0, 240, 3)])
    gdf = pd.DataFrame(gmap)
    for f in ("snp_asGeneticPos", "snp_asGeneticPos2"):
        a = getattr(pm, f)(chrs, pos, gmap)
        b = getattr(jm, f)(chrs, pos, gdf)
        assert np.array_equal(a, b)
    assert np.array_equal(pm.snp_asGeneticPos(chrs, pos, gmap, rsid=rsid),
                          jm.snp_asGeneticPos(chrs, pos, gdf, rsid=rsid))
    assert np.array_equal(pm.snp_asGeneticPos(chrs, pos),
                          jm.snp_asGeneticPos(chrs, pos))
