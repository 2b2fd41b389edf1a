"""Banded representation of the sparse LD matrix (port of
`bigsnpr_tpu/pgs/band.py`).

The reference's SFBM column access `incr_mult_col(j, dotprods, diff)`
(bigsparser, used at src/ldpred2.cpp:62) becomes a fixed-width banded
row: snp_cor only links variants within a position window
(src/corr.cpp:52-53), so every column's support lies in [j-W, j+W].
"""

from __future__ import annotations

import numpy as np

from bigsnpr_tpu_torch.pgs.gibbs_blocked import BlockBands


def build_band(corr, dtype=np.float32):
    """SparseLD -> (band (m2, 2W+1), W). band[j, W+d] = R[j, j+d]."""
    S = corr.sym().tocoo()
    m2 = S.shape[0]
    if S.nnz == 0:
        return np.zeros((m2, 1), dtype=dtype), 0
    offs = S.col - S.row
    W = int(np.abs(offs).max())
    band = np.zeros((m2, 2 * W + 1), dtype=dtype)
    band[S.row, W + offs] = S.data
    return band, W


def one_block_bands(corr, ind_corr=None, dtype=np.float32) -> BlockBands:
    """The LD of the unblocked samplers: one block of every variant of the
    subset, `build_band` of corr[ind_corr][:, ind_corr] as the one bucket
    of a BlockBands (nothing is dropped). The JAX package walks
    `band[ind_corr]` over a dp of m2 + 2W entries instead; the entries at
    variants outside the subset are written there and never read, so the
    sweeps are the same."""
    m2 = corr.shape[0]
    if ind_corr is not None and not np.array_equal(np.asarray(ind_corr),
                                                   np.arange(m2)):
        corr = corr.subset(ind_corr)
    band, _ = build_band(corr, dtype=dtype)
    m = band.shape[0]
    return BlockBands([(band[None], np.arange(m, dtype=np.int32)[None])], m)
