"""C+T polygenic risk scores.

Reference: snp_PRS (R/PRS.R:36-76): scores at decreasing p-value
thresholds; allele reversals handled by sign flip + constant
(prodVecRev, R/PRS.R:3-7). Winner's-curse correction snp_thr_correct
(R/PRS.R:112-136).

All thresholds go through ONE product: column i of a full-width (m, n_thr)
matrix holds the kept betas passing threshold i, and `snp_prodVec` (kernel
K2 on CUDA) scores every threshold in one pass over the packed bytes.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as scipy_stats

from bigsnpr_tpu_torch.ops.matvec import snp_prodVec
from bigsnpr_tpu_torch.utils.assertions import check_args


@check_args()
def snp_PRS(pack, betas_keep, ind_test=None, ind_keep=None, same_keep=None,
            lpS_keep=None, thr_list=0, device=None):
    """Returns the (len(ind_test), len(thr_list)) score matrix.

    ind_keep must not repeat an index when thresholds are used (the JAX
    package keeps only the last write of a repeated index there)."""
    sub = (pack if ind_test is None
           else pack.subset(ind_row=np.asarray(ind_test), device=device))
    if ind_keep is None:
        ind_keep = np.arange(sub.m)
    ind_keep = np.asarray(ind_keep)
    betas_keep = np.asarray(betas_keep, dtype=np.float64)
    if len(betas_keep) != len(ind_keep):
        raise ValueError("snp_PRS: betas_keep and ind_keep lengths differ")
    if same_keep is None:
        same_keep = np.ones(len(ind_keep), dtype=bool)
    same_keep = np.asarray(same_keep, dtype=bool)
    betas_mod = (2 * same_keep.astype(np.float64) - 1) * betas_keep

    if lpS_keep is None or (np.isscalar(thr_list) and thr_list == 0):
        print("'lpS_keep' or 'thr_list' was not specified. Thresholding disabled.")
        # prodVecRev: X[:, keep] @ ((2*same-1)*betas) + 2*sum(betas[~same]);
        # a repeated index adds up, as in the reference
        u = np.zeros(sub.m)
        np.add.at(u, ind_keep, betas_mod)
        score = np.asarray(snp_prodVec(sub, u, device=device), np.float64)
        return (score + 2 * betas_keep[~same_keep].sum())[:, None]

    thr_arr = np.atleast_1d(np.asarray(thr_list, dtype=np.float64))
    lpS_keep = np.asarray(lpS_keep, dtype=np.float64)
    if np.any(lpS_keep < 0):
        raise ValueError("snp_PRS: lpS_keep must be non-negative")
    mask = lpS_keep[:, None] > thr_arr[None, :]          # (k, n_thr)
    B = np.zeros((sub.m, len(thr_arr)))
    B[ind_keep] = betas_mod[:, None] * mask
    scores = np.asarray(snp_prodVec(sub, B, device=device), dtype=np.float64)
    consts = 2.0 * (((~same_keep) * betas_keep) @ mask)
    return scores + consts[None, :]


def snp_thr_correct(beta, beta_se=None, lpS=None, thr_lpS=0.0):
    """Winner's-curse bias reduction (Zhong & Prentice 2008),
    reference snp_thr_correct (R/PRS.R:112-136)."""
    beta = np.asarray(beta, dtype=np.float64)
    if thr_lpS < 0:
        raise ValueError("'thr_lpS' must be positive (or 0).")
    if thr_lpS == 0:
        return beta.copy()

    if beta_se is not None:
        z = np.abs(beta / np.asarray(beta_se, dtype=np.float64))
    elif lpS is not None:
        lpS = np.asarray(lpS, dtype=np.float64)
        z = np.sqrt(scipy_stats.chi2.isf(
            np.exp(np.minimum(-lpS / np.log10(np.e), 0)), df=1))
    else:
        raise ValueError("'beta_se' and 'lpS' cannot be both missing.")

    thr_Z = np.sqrt(scipy_stats.chi2.isf(10.0**-thr_lpS, df=1))
    Z = np.linspace(0, 10 * z.max(), 1_000_000)
    Z2 = Z + (scipy_stats.norm.pdf(Z - thr_Z) - scipy_stats.norm.pdf(-Z - thr_Z)) / (
        scipy_stats.norm.cdf(Z - thr_Z) + scipy_stats.norm.cdf(-Z - thr_Z))
    # nearest-neighbor inversion of the shrinkage map (reference uses knn)
    idx = np.searchsorted(Z2, z)
    idx = np.clip(idx, 1, len(Z) - 1)
    left_closer = np.abs(Z2[idx - 1] - z) <= np.abs(Z2[idx] - z)
    new_z = Z[np.where(left_closer, idx - 1, idx)]

    with np.errstate(invalid="ignore", divide="ignore"):
        shrink = np.minimum(new_z / z, 1.0)
    return np.where(z >= thr_Z, beta * shrink, 0.0)
