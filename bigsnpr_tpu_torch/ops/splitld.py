"""Optimal LD splitting into near-independent blocks (port of
`bigsnpr_tpu/ops/splitld.py`).

Reference: snp_ldsplit (R/split-LD.R:99-138, src/split-LD.cpp): exact DP
minimizing the sum of squared correlations outside blocks, tie-broken on
the sum of squared block sizes, with min/max block size, a max_r2
forbidden-pair infinity cost, and a scaled-position window constraint.

The tables and the DP run in `native/ldsplit_native.cpp` (a copy of the
JAX package's native source), built with g++ at first use into `_build/`
and loaded with ctypes. The result is a dict of numpy columns where the
JAX package returns a DataFrame.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp

from bigsnpr_tpu_torch.ops import cuda_build
from bigsnpr_tpu_torch.ops.corr import SparseLD

SOURCE = cuda_build.PKG / "native" / "ldsplit_native.cpp"
COLUMNS = ("max_size", "n_block", "cost", "cost2", "perc_kept", "all_last",
           "all_size")


def _bind(lib):
    p, i64, f64, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                        ctypes.c_int)
    for name, argtypes in (
            ("ldsplit_suffix", [p, p, p, i64, f64, f64, p]),
            ("ldsplit_entries", [p, p, p, i64, i64, i64, f64, p, i32, p, p,
                                 p, p, p]),
            ("ldsplit_group_rows", [p, p, p, i64, i64, p, p, p]),
            ("ldsplit_dp", [p, p, p, i64, i64, i64, i64, f64, p, p, p])):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = argtypes


def _lib():
    return cuda_build.load(SOURCE, _bind)


def _suffix_tables(lower, thr_r2: float, max_r2: float):
    """Per-column suffix sums of transformed r^2 (reference get_L,
    src/split-LD.cpp:16-61)."""
    lib = _lib()
    indptr = np.ascontiguousarray(lower.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(lower.indices, dtype=np.int64)
    data = np.ascontiguousarray(lower.data, dtype=np.float64)
    suff = np.empty(lower.nnz)
    lib.ldsplit_suffix(indptr.ctypes.data, indices.ctypes.data,
                       data.ctypes.data, lower.shape[0], thr_r2, max_r2,
                       suff.ctypes.data)
    return indptr, indices, suff


def _tables(suffix_tables, m, min_size, max_size, max_K, max_cost,
            pos_scaled):
    """Block-cost entries + DP tables (reference get_C,
    src/split-LD.cpp:66-145): (C1 row 0 (max_K,), best (m, max_K))."""
    lib = _lib()
    indptr, indices, suff = suffix_tables
    pos_scaled = np.ascontiguousarray(pos_scaled, dtype=np.float64)
    counts = np.zeros(m, dtype=np.int64)
    lib.ldsplit_entries(indptr.ctypes.data, indices.ctypes.data,
                        suff.ctypes.data, m, min_size, max_size, max_cost,
                        pos_scaled.ctypes.data, 1, counts.ctypes.data,
                        None, None, None, None)
    total = int(counts.sum())
    offsets = np.zeros(m, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    rows = np.empty(total, dtype=np.int32)
    cols = np.empty(total, dtype=np.int32)
    E = np.empty(total, dtype=np.float32)
    lib.ldsplit_entries(indptr.ctypes.data, indices.ctypes.data,
                        suff.ctypes.data, m, min_size, max_size, max_cost,
                        pos_scaled.ctypes.data, 0, counts.ctypes.data,
                        offsets.ctypes.data, rows.ctypes.data,
                        cols.ctypes.data, E.ctypes.data)
    row_ptr = np.empty(m + 1, dtype=np.int64)
    cols2 = np.empty(total, dtype=np.int32)
    E2 = np.empty(total, dtype=np.float32)
    lib.ldsplit_group_rows(rows.ctypes.data, cols.ctypes.data, E.ctypes.data,
                           total, m, row_ptr.ctypes.data, cols2.ctypes.data,
                           E2.ctypes.data)
    c1row0 = np.empty(max_K)
    best = np.full((m, max_K), -1, dtype=np.int32)
    lib.ldsplit_dp(row_ptr.ctypes.data, cols2.ctypes.data, E2.ctypes.data,
                   m, min_size, max_size, max_K, max_cost,
                   pos_scaled.ctypes.data, c1row0.ctypes.data,
                   best.ctypes.data)
    return c1row0, best


def _get_perc(lower: sp.csc_matrix, all_last: np.ndarray) -> float:
    """Fraction of nonzero LD values inside the blocks (reference
    get_perc, src/split-LD.cpp:150-182)."""
    m = lower.shape[0]
    count_all = 2 * lower.nnz - m
    limits = np.asarray(all_last)  # last index (0-based) of each block
    col_limit = limits[np.searchsorted(limits, np.arange(m))]
    entry_limit = np.repeat(col_limit, np.diff(lower.indptr))
    outside = int((lower.indices > entry_limit).sum())
    return (count_all - 2 * outside) / count_all


def snp_ldsplit(corr, thr_r2: float, min_size: int, max_size,
                max_K: int = 500, max_r2: float = 0.3,
                max_cost: float | None = None, pos_scaled=None):
    """Reference snp_ldsplit (R/split-LD.R:99-138). Returns a dict of
    numpy columns (`COLUMNS`; all_last and all_size are object arrays of
    int arrays, one row per solution), or None when no split exists."""
    S = corr.sym() if isinstance(corr, SparseLD) else sp.csc_matrix(corr)
    m = S.shape[0]
    lower = sp.tril(S).tocsc()
    lower.sort_indices()
    assert np.all(lower.diagonal() != 0), "diagonal must be nonzero"
    max_sizes = np.atleast_1d(np.asarray(max_size, dtype=np.int64))
    assert min_size >= 1 and np.all(max_sizes <= m)
    if pos_scaled is None:
        pos_scaled = np.zeros(m)
    pos_scaled = np.asarray(pos_scaled, dtype=np.float64)
    if max_cost is None:
        max_cost = m / 200
    max_cost = min(max_cost, 2 * float(lower.data @ lower.data))

    suffix = _suffix_tables(lower, thr_r2, max_r2)
    prev_costs = np.full(max_K, np.inf)
    rows = []
    for one_max in np.sort(max_sizes):
        c1row0, best = _tables(suffix, m, min_size, int(one_max), max_K,
                               max_cost, pos_scaled)
        for K in range(1, max_K + 1):
            cost = c1row0[K - 1]
            if cost > max_cost or not (cost < prev_costs[K - 1]):
                continue
            prev_costs[K - 1] = cost
            all_last = []
            j, k = 0, K - 1
            while True:
                j = best[j, k]
                all_last.append(j)
                if k == 0:
                    break
                k -= 1
            all_last = np.asarray(all_last)
            assert len(all_last) == K
            all_size = np.diff(np.r_[0, all_last])
            assert np.all((all_size >= min_size) & (all_size <= one_max))
            rows.append((int(one_max), K, cost,
                         float((all_size.astype(float) ** 2).sum()),
                         _get_perc(lower, all_last - 1), all_last, all_size))
    if not rows:
        return None
    out = {}
    for c, name in enumerate(COLUMNS):
        vals = [r[c] for r in rows]
        if name in ("all_last", "all_size"):
            col = np.empty(len(vals), dtype=object)
            col[:] = vals
        else:
            col = np.asarray(vals)
        out[name] = col
    return out


def block_num(all_size) -> np.ndarray:
    """Per-variant block ids from block sizes (reference doc
    R/split-LD.R:90-91)."""
    return np.repeat(np.arange(1, len(all_size) + 1), all_size)
