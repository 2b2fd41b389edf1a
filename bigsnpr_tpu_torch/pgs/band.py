"""Banded representation of the sparse LD matrix (port of
`bigsnpr_tpu/pgs/band.py`).

The reference's SFBM column access `incr_mult_col(j, dotprods, diff)`
(bigsparser, used at src/ldpred2.cpp:62) becomes a fixed-width banded
row: snp_cor only links variants within a position window
(src/corr.cpp:52-53), so every column's support lies in [j-W, j+W].
"""

from __future__ import annotations

import numpy as np


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
