"""Weir-Cockerham Fst (reference snp_fst, R/Fst.R:47-85).

A copy of `bigsnpr_tpu/assoc/fst.py` (host numpy); the per-population
tables are dicts of columns, as `bed_MAF` returns them."""

from __future__ import annotations

import numpy as np


def snp_fst(list_df_af, min_maf: float = 0.0, overall: bool = False):
    """list_df_af: list of DataFrames/dicts with 'af' and 'N' per population
    (e.g. outputs of bed_MAF)."""
    r = len(list_df_af)
    if r < 2:
        raise ValueError("You should provide frequencies for at least 2 populations.")
    if not (0 <= min_maf <= 0.45):
        raise ValueError("Parameter 'min_maf' should be in range [0, 0.45].")

    af = np.stack([np.asarray(df["af"], dtype=np.float64) for df in list_df_af])
    N = np.stack([np.asarray(df["N"], dtype=np.float64) for df in list_df_af])

    n_sum = N.sum(axis=0)
    n_bar = n_sum / r
    n_sqsum = (N**2).sum(axis=0)
    n_c = (n_sum - n_sqsum / n_sum) / (r - 1)

    p_bar = (af * N).sum(axis=0) / n_sum
    s2 = ((af - p_bar) ** 2 * N).sum(axis=0) / n_bar / (r - 1)
    h_bar = (2 * af * (1 - af) * N).sum(axis=0) / n_sum

    a = n_bar / n_c * (s2 - 1 / (n_bar - 1) *
                       (p_bar * (1 - p_bar) - (r - 1) / r * s2 - h_bar / 4))
    b = n_bar / (n_bar - 1) * (p_bar * (1 - p_bar) - (r - 1) / r * s2
                               - (2 * n_bar - 1) / (4 * n_bar) * h_bar)
    c = h_bar / 2

    keep = (p_bar > min_maf) & (p_bar < 1 - min_maf)
    if overall:
        return float(a[keep].sum() / (a + b + c)[keep].sum())
    with np.errstate(invalid="ignore"):
        return np.where(keep, a / (a + b + c), np.nan)
