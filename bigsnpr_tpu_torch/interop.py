"""Carry state across from the JAX package, given as numpy arrays only.

Nothing here imports the JAX package: callers hand over its packed bytes,
sample count, metadata columns, scaling and SVD factors as numpy arrays
(or anything `np.asarray` and column access can read), and get the
port's `GenoPack` / `BigSVD` holding the same values.
"""

from __future__ import annotations

import numpy as np

from bigsnpr_tpu_torch.core.genotypes import FAM_COLS, MAP_COLS, GenoPack
from bigsnpr_tpu_torch.linalg.randomsvd import BigSVD


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


def svd_from_numpy(d, u, v, center, scale, niter: int = 0) -> BigSVD:
    """A port `BigSVD` from the factors and scaling of a JAX one."""
    f64 = lambda a: np.array(a, dtype=np.float64)  # noqa: E731
    return BigSVD(d=f64(d), u=f64(u), v=f64(v), center=f64(center),
                  scale=f64(scale), niter=int(niter))
