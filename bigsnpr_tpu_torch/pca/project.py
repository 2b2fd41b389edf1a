"""PCA projection of new samples onto reference PCs, with OADP shrinkage
correction (port of `bigsnpr_tpu/pca/project.py`).

Reference: bed_projectPCA / bed_projectSelfPCA (R/bed-projectPCA.R:100-281)
on the fused XᵀV + row-norms kernel (src/bed-fun.cpp:103-133,
src/project-utils.cpp:12-43), and bigutilsr::pca_OADP_proj2 (external):
Online Augmentation, Decomposition, and Procrustes (Zhang, Dey & Lee 2020).

`prod_and_row_sums_sq` is the JAX package's XLA scan as torch ops: one
pass over blocks of the variants, each decoded and standardized once for
both X̃ V (at `config.matmul_precision`, `ops/precision.py`) and the row
sums of X̃². `pca_OADP_proj` is a copy of the host
numpy code. `bed_projectPCA` matches the two maps with `utils/match`.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.unpack import unpack_standardized
from bigsnpr_tpu_torch.ops import precision
from bigsnpr_tpu_torch.ops.blocks import pick_block


def prod_and_row_sums_sq(pack, V, center, scale, ind_col=None, block=None,
                         device=None):
    """(XV (n, K), X_norm (n,)) on the standardized columns ind_col, float32
    on the device, returned as float64 numpy. The columns are gathered
    from the cached device pack."""
    dev = config.resolve_device(device)
    packed = pack.device_packed(dev)
    n = pack.n
    cols = (None if ind_col is None else
            torch.as_tensor(np.asarray(ind_col), dtype=torch.long, device=dev))
    m = pack.m if cols is None else len(cols)
    V = np.asarray(V, dtype=np.float64)
    assert V.shape[0] == m
    block = block or pick_block(n)
    prec = precision.resolve()
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),  # noqa: E731
                                    device=dev)
    Vt, c, s = f32(V), f32(center), f32(scale)
    xv = torch.zeros((n, V.shape[1]), dtype=torch.float32, device=dev)
    xn = torch.zeros(n, dtype=torch.float32, device=dev)
    for j0 in range(0, m, block):
        j1 = min(m, j0 + block)
        pb = packed[j0:j1] if cols is None else packed[cols[j0:j1]]
        xt = unpack_standardized(pb, n, c[j0:j1], s[j0:j1])   # (block, n)
        xv += precision.mm(xt.T, Vt[j0:j1], prec)
        xn += (xt * xt).sum(dim=0)
    return (xv.cpu().numpy().astype(np.float64),
            xn.cpu().numpy().astype(np.float64))


def pca_OADP_proj(XV: np.ndarray, X_norm: np.ndarray, sval: np.ndarray):
    """OADP-corrected projection (bigutilsr::pca_OADP_proj2 surface)."""
    XV = np.asarray(XV, dtype=np.float64)
    X_norm = np.asarray(X_norm, dtype=np.float64)
    sval = np.asarray(sval, dtype=np.float64)
    K = len(sval)
    d2 = sval**2
    out = np.empty_like(XV)
    for i in range(XV.shape[0]):
        z = XV[i]
        r2 = max(X_norm[i] - z @ z, 0.0)
        b = np.r_[z, np.sqrt(r2)]
        A = np.diag(np.r_[d2, 0.0]) + np.outer(b, b)
        lam, U = np.linalg.eigh(A)
        lam, U = lam[::-1][:K], U[:, ::-1][:, :K]
        # augmented score of the new sample
        t = b @ U
        # Procrustes of augmented ref scores (A_ref = U S Ubar) onto U S:
        # M = Ubar^T diag(d2); R from SVD(M), scale rho
        Ubar = U[:K, :]
        M = Ubar.T @ np.diag(d2)
        P, Sig, Qt = np.linalg.svd(M)
        R = P @ Qt
        denom = np.trace(Ubar.T @ np.diag(d2) @ Ubar)
        rho = Sig.sum() / denom if denom > 0 else 1.0
        out[i] = rho * (t @ R)
    return out


def bed_projectSelfPCA(obj_svd, pack, ind_row=None, ind_col=None,
                       device=None) -> dict:
    """Project (other) individuals of the same dataset on obj_svd
    (reference bed_projectSelfPCA, R/bed-projectPCA.R:196-225)."""
    if ind_col is None:
        ind_col = obj_svd.subset
    assert ind_col is not None, "pass ind_col (or use autoSVD's subset)"
    dev = config.resolve_device(device)
    sub = (pack if ind_row is None
           else pack.subset(ind_row=np.asarray(ind_row), device=dev))
    XV, X_norm = prod_and_row_sums_sq(sub, obj_svd.v, obj_svd.center,
                                      obj_svd.scale, ind_col=ind_col,
                                      device=dev)
    return {
        "obj.svd.ref": obj_svd,
        "simple_proj": XV,
        "OADP_proj": pca_OADP_proj(XV, X_norm, obj_svd.d),
    }


snp_projectSelfPCA = bed_projectSelfPCA


def bed_projectPCA(pack_ref, pack_new, k: int = 10, ind_row_new=None,
                   ind_row_ref=None, ind_col_ref=None, strand_flip=True,
                   join_by_pos=True, match_min_prop=0.5, verbose=False,
                   device=None, **autosvd_kw) -> dict:
    """Match variants, autoSVD the reference, project the target
    (reference bed_projectPCA, R/bed-projectPCA.R:100-172). The matching
    is `utils/match.snp_match` on the two maps; the reference's SVD runs
    on the operator of the configured scheme (K1 / K2 by default)."""
    from bigsnpr_tpu_torch.pca.autosvd import bed_autoSVD
    from bigsnpr_tpu_torch.utils.match import snp_match

    dev = config.resolve_device(device)
    if pack_ref.map is None or pack_new.map is None:
        raise ValueError("bed_projectPCA matches the variants of the two "
                         "packs by their maps: both packs need a map")

    def remap(map_):
        return {"chr": np.asarray(map_["chromosome"]),
                "rsid": np.asarray(map_["marker.ID"]),
                "pos": np.asarray(map_["physical.pos"]),
                "a1": np.asarray(map_["allele1"]),
                "a0": np.asarray(map_["allele2"])}

    map_ref = remap(pack_ref.map)
    map_ref["beta"] = np.ones(pack_ref.m)
    info_snp = snp_match(map_ref, remap(pack_new.map),
                         strand_flip=strand_flip, join_by_pos=join_by_pos,
                         match_min_prop=match_min_prop, verbose=verbose)

    num_ref = info_snp["_NUM_ID_.ss"] - 1
    num_new = info_snp["_NUM_ID_"] - 1
    ind_col = num_ref if ind_col_ref is None else np.intersect1d(
        np.asarray(ind_col_ref), num_ref)

    obj_svd = bed_autoSVD(pack_ref, ind_row=ind_row_ref, ind_col=ind_col,
                          k=k, verbose=verbose, device=dev, **autosvd_kw)

    # keep = match(subset, num_ref); num_ref is not necessarily sorted
    order = np.argsort(num_ref)
    at = np.searchsorted(num_ref[order], obj_svd.subset)
    keep = order[np.minimum(at, len(order) - 1)]
    if not np.array_equal(num_ref[keep], obj_svd.subset):
        raise ValueError("bed_projectPCA: the SVD's subset is not among "
                         "the matched variants")
    beta = info_snp["beta"][keep]
    center = (obj_svd.center - 1) * beta + 1
    scale = obj_svd.scale * beta

    sub_new = (pack_new if ind_row_new is None
               else pack_new.subset(ind_row=np.asarray(ind_row_new),
                                    device=dev))
    XV, X_norm = prod_and_row_sums_sq(sub_new, obj_svd.v, center, scale,
                                      ind_col=num_new[keep], device=dev)
    return {
        "obj.svd.ref": obj_svd,
        "simple_proj": XV,
        "OADP_proj": pca_OADP_proj(XV, X_norm, obj_svd.d),
    }
