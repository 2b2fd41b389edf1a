"""Remaining small API-surface pieces of the reference NAMESPACE.

A port of `bigsnpr_tpu/utils/misc.py` on dicts of numpy columns (port
DEVIATIONS #1): `snp_getSampleInfos` reads whitespace tables without
pandas and returns a dict; `snp_split(combine="rbind")` concatenates the
per-chromosome dicts. `snp_pruning` and the downloads raise, as in the
JAX package.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from bigsnpr_tpu_torch.io.bed import _typed
from bigsnpr_tpu_torch.ops.corr import SparseLD


def sub_bed(bedfile, replacement: str = "", stop_if_not_ext: bool = True) -> str:
    """Replace the '.bed' extension (reference bigsnpr::sub_bed)."""
    s = str(bedfile)
    if s.endswith(".bed"):
        return s[:-4] + replacement
    if stop_if_not_ext:
        raise ValueError(f"Path '{s}' must have 'bed' extension.")
    return s + replacement


def as_SFBM(corr) -> SparseLD:
    """Convert a (scipy) sparse symmetric correlation matrix to the
    framework's SparseLD (the reference's SFBM analog)."""
    if isinstance(corr, SparseLD):
        return corr
    S = sp.csc_matrix(corr)
    return SparseLD(upper=sp.triu(S).tocsc())


def _read_header_table(path) -> dict:
    """A whitespace table with a header line as a dict of typed numpy
    columns (int64, else float64, else str); a file without a header line
    raises ValueError (pandas: EmptyDataError, a ValueError)."""
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    if not lines:
        raise ValueError(f"No columns to parse from file {path}")
    names, rows = lines[0], lines[1:]
    for i, r in enumerate(rows):
        if len(r) != len(names):
            raise ValueError(f"{path}: line {i + 2} has {len(r)} fields, "
                             f"expected {len(names)}")
    cols = list(zip(*rows)) if rows else [()] * len(names)
    return {name: _typed(list(col)) for name, col in zip(names, cols)}


def _with_missing(values: np.ndarray, miss: np.ndarray) -> np.ndarray:
    """A column with the rows `miss` set to NaN (floats; others as objects)."""
    if not miss.any():
        return values
    if values.dtype.kind in "iufb":
        out = values.astype(np.float64)
    else:
        out = values.astype(object)
    out[miss] = np.nan
    return out


def snp_getSampleInfos(pack, df_or_files, col_family_ID: int = 0,
                       col_sample_ID: int = 1, col_infos=None,
                       pair_sep: str = "-_-") -> dict:
    """Match external per-sample info to the pack's fam
    (reference snp_getSampleInfos, R/get-save-infos.R:26-86). The info is
    a dict of columns (or a DataFrame), or one or more whitespace files
    with a header line; returns a dict of columns, NaN where a sample was
    not matched."""
    if isinstance(df_or_files, (str, Path)):
        df_or_files = [df_or_files]
    if isinstance(df_or_files, (list, tuple)):
        tables = [_read_header_table(f) for f in df_or_files]
        data = {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}
    else:
        data = {k: np.asarray(df_or_files[k]) for k in list(df_or_files.keys())}
    names = list(data)
    fam = pack.fam
    to_match = [f"{a}{pair_sep}{b}" for a, b in
                zip(fam["family.ID"], fam["sample.ID"])]
    from_match = [f"{a}{pair_sep}{b}" for a, b in
                  zip(data[names[col_family_ID]], data[names[col_sample_ID]])]
    lookup = {}
    for i, s in enumerate(from_match):
        lookup.setdefault(s, i)
    num = np.array([lookup.get(s, -1) for s in to_match], dtype=np.int64)
    miss = num < 0
    if miss.any():
        warnings.warn(f"There are {int(miss.sum())} individuals which have "
                      "not been matched")
    if col_infos is None:
        cols = [c for k, c in enumerate(names)
                if k not in (col_family_ID, col_sample_ID)]
    else:
        cols = [names[k] for k in np.atleast_1d(col_infos)]
    rows = np.where(miss, 0, num)
    return {c: _with_missing(data[c][rows], miss) for c in cols}


def snp_split(infos_chr, FUN, combine=None, ncores: int | None = None, **kw):
    """Per-chromosome split-apply, longest chromosome first
    (reference snp_split, R/apply-parallelize.R:35-57). combine: None (a
    list), "c" (concatenated arrays), "rbind" (the dicts of columns
    concatenated) or a function of two results."""
    infos_chr = np.asarray(infos_chr)
    chrs, inv = np.unique(infos_chr, return_inverse=True)
    ind_chrs = [np.nonzero(inv == k)[0] for k in range(len(chrs))]
    order = np.argsort([-len(ix) for ix in ind_chrs])

    def run(k):
        return FUN(ind_chr=ind_chrs[k], chr=chrs[k], **kw)

    if ncores and ncores > 1:
        with ThreadPoolExecutor(max_workers=ncores) as ex:
            res = list(ex.map(run, order))
    else:
        res = [run(k) for k in order]
    res_ordered = [None] * len(chrs)
    for pos, k in enumerate(order):
        res_ordered[k] = res[pos]
    if combine is None:
        return res_ordered
    if combine == "c":
        return np.concatenate(res_ordered)
    if combine == "rbind":
        keys = list(res_ordered[0].keys())
        return {k: np.concatenate([np.asarray(r[k]) for r in res_ordered])
                for k in keys}
    out = res_ordered[0]
    for r in res_ordered[1:]:
        out = combine(out, r)
    return out


def snp_pruning(*args, **kw):
    """Deprecated in the reference (R/clumping.R:143-155)."""
    raise RuntimeError("Pruning is deprecated; please use clumping "
                       "(on MAF) instead.")


def download_1000G(dir=None, overwrite=False):
    raise RuntimeError(
        "No network access here; place the 1000G phase-3 bed/bim/fam "
        "(reference R/bed-projectPCA.R:21-41) in `dir` manually and use "
        "read_bed().")


def download_genetic_map(type="hg19_OMNI", dir=None, ncores=1):
    raise RuntimeError(
        "No network access here; provide a genetic map (a dict of columns "
        "pos, pos_cM) to snp_asGeneticPos() directly.")
