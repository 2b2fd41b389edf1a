"""LD scores (port of `bigsnpr_tpu/ops/ldscores.py`).

Reference: ld_scores0 (src/ld-scores.cpp:12-78): for each variant j0,
score = 1 + sum of pairwise-complete r^2 against all window neighbours,
accumulated symmetrically; NaN r^2 skipped. Same pair sums as `snp_cor`
(exact integers, or float64 on a DosagePack's byte path).
"""

from __future__ import annotations

import numpy as np

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.ops.corr import (
    SparseLD, _host_sums, _pair_r, _window_geometry, band_blocks,
)


def snp_ld_scores(pack, ind_row=None, ind_col=None, size: float = 500,
                  infos_pos=None, block: int = 512,
                  device=None) -> np.ndarray:
    """Reference snp_ld_scores / bed_ld_scores (R/ld-scores.R:41-72)."""
    dev = config.resolve_device(device)
    sub = pack
    if ind_col is not None or ind_row is not None:
        sub = pack.subset(ind_row=ind_row, ind_col=ind_col, device=dev)
    n, m = sub.n, sub.m
    if infos_pos is None:
        pos = 1000.0 * np.arange(1, m + 1)
    else:
        pos = np.asarray(infos_pos, dtype=np.float64)
    left_start = _window_geometry(pos, size * 1000.0)
    blocks, nona = band_blocks(sub, dev, left_start, block)
    res = np.ones(m)
    for t0, t1, b0, sums in blocks:
        r, _ = _pair_r(_host_sums(sums, nona))
        jj0 = np.arange(t0, t1)[:, None]
        jj = np.arange(b0, t1)[None, :]
        in_window = (jj < jj0) & (jj >= left_start[jj0])
        r2 = r * r
        valid = in_window & ~np.isnan(r2)
        r2 = np.where(valid, r2, 0.0)
        res[t0:t1] += r2.sum(axis=1)                      # j0 side
        np.add.at(res, np.arange(b0, t1), r2.sum(axis=0))  # neighbour side
    return res


bed_ld_scores = snp_ld_scores


def ld_scores_sfbm(corr: SparseLD, ind_sub=None) -> np.ndarray:
    """Sum of squared LD entries per column, restricted to a sub-index set
    (reference src/ld-scores-sfbm.cpp:10-69). Includes the diagonal."""
    return corr.col_sums_sq(ind_sub=ind_sub)
