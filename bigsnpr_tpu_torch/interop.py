"""Carry state across from the JAX package, given as numpy arrays only.

Nothing here imports the JAX package: callers hand over its packed bytes,
sample count, metadata columns, scaling and SVD factors (and an autoSVD
subset), sparse LD (CSC arrays) and block bands (host buckets) as numpy
arrays (or anything
`np.asarray` and column access can read), and get the port's `GenoPack`,
`BigSVD`, `SparseLD` / `BlockBands` / `GridPRS` holding the same values.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from bigsnpr_tpu_torch.core.genotypes import FAM_COLS, MAP_COLS, GenoPack
from bigsnpr_tpu_torch.linalg.randomsvd import BigSVD
from bigsnpr_tpu_torch.ops.corr import SparseLD
from bigsnpr_tpu_torch.pgs.gibbs_blocked import BlockBands
from bigsnpr_tpu_torch.pgs.sct import GridPRS, _chrom_key


def columns(table, names=None):
    """A table with column access (a dict of arrays, or a DataFrame, read
    through `table[name]`) as a dict of numpy columns. None stays None."""
    if table is None:
        return None
    names = list(table.keys()) if names is None else names
    return {k: np.asarray(table[k]) for k in names}


def pack_from_numpy(packed, n, fam=None, map=None) -> GenoPack:
    """A port `GenoPack` on a copy of the (m, ceil(n/4)) packed bytes."""
    packed = np.ascontiguousarray(np.asarray(packed, dtype=np.uint8))
    if packed.ndim != 2 or packed.shape[1] != (int(n) + 3) // 4:
        raise ValueError(f"packed {packed.shape} does not hold n={n} samples")
    return GenoPack(packed=packed.copy(), n=int(n),
                    fam=columns(fam, None if fam is None else
                                [c for c in FAM_COLS if c in fam]),
                    map=columns(map, None if map is None else
                                [c for c in MAP_COLS if c in map]))


def svd_from_numpy(d, u, v, center, scale, niter: int = 0,
                   subset=None) -> BigSVD:
    """A port `BigSVD` from the factors and scaling of a JAX one (and the
    kept variants of an autoSVD result)."""
    f64 = lambda a: np.array(a, dtype=np.float64)  # noqa: E731
    return BigSVD(d=f64(d), u=f64(u), v=f64(v), center=f64(center),
                  scale=f64(scale), niter=int(niter),
                  subset=None if subset is None else np.array(subset))


def sparse_ld_from_numpy(data, indices, indptr, shape, pos=None) -> SparseLD:
    """A port `SparseLD` from the CSC arrays of an upper-triangular LD
    matrix (a JAX `SparseLD.upper`'s data, indices, indptr, shape)."""
    upper = sp.csc_matrix((np.array(data), np.array(indices),
                           np.array(indptr)), shape=tuple(shape))
    return SparseLD(upper=upper,
                    pos=None if pos is None else np.array(pos, np.float64))


def block_bands_from_numpy(buckets, m, dropped_r2=0.0,
                           kept_r2=0.0) -> BlockBands:
    """A port `BlockBands` from host buckets [(bands (Bk, mbk, 2W+1),
    gidx (Bk, mbk)), ...], as a JAX `BlockBands.buckets` holds them."""
    return BlockBands([(np.array(b), np.array(g, dtype=np.int32))
                       for b, g in buckets], int(m), dropped_r2=dropped_r2,
                      kept_r2=kept_r2)


def grid_prs_from_numpy(scores, lpS, grid_lpS_thr, betas, all_keep) -> GridPRS:
    """A port `GridPRS` from a JAX one's score matrix, lpS, thresholds,
    betas and keep sets ({chromosome: [index arrays]}), in memory."""
    f64 = lambda a: np.array(a, dtype=np.float64)  # noqa: E731
    keep = {_chrom_key(c): [np.array(k, dtype=np.int64) for k in ks]
            for c, ks in all_keep.items()}
    return GridPRS(scores=np.array(scores, dtype=np.float32), lpS=f64(lpS),
                   grid_lpS_thr=f64(grid_lpS_thr), betas=f64(betas),
                   all_keep=keep)
