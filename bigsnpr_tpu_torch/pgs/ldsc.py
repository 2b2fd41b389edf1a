"""LD score regression (port of `bigsnpr_tpu/pgs/ldsc.py`, host float64).

Faithful re-implementation of the reference's 2-step IRWLS with
heteroscedasticity weights and delete-a-group jackknife SEs
(reference R/ldsc.R:3-157). Pure vectorizable math; runs in f64 numpy
(matches the R arithmetic bit-for-bit up to summation order).
"""

from __future__ import annotations

import numpy as np
from scipy import stats as scipy_stats


def _weights(pred, w_ld):
    return 1.0 / (pred**2 * w_ld)


def _wlm(x, y, w):
    """Weighted least squares with intercept (reference R/ldsc.R:11-21)."""
    wx = w * x
    W = w.sum()
    WX = wx.sum()
    WY = w @ y
    WXX = wx @ x
    WXY = wx @ y
    denom = W * WXX - WX**2
    alpha = (WXX * WY - WX * WXY) / denom
    beta = (WXY * W - WX * WY) / denom
    return alpha, beta, x * beta + alpha


def _wlm_no_int(x, y, w):
    wx = w * x
    beta = (wx @ y) / (wx @ x)
    return beta, x * beta


def _ldsc_fit(ld_score, ld_size, chi2, sample_size, intercept,
              chi2_thr1, chi2_thr2):
    """One LDSC fit, no SEs (reference R/ldsc.R:85-122)."""
    # step 1: intercept on chi2 < thr1
    if intercept is None:
        sub1 = chi2 < chi2_thr1
        w_ld = np.maximum(ld_score[sub1], 1)
        x1 = (ld_score / ld_size * sample_size)[sub1]
        y1 = chi2[sub1]
        pred0 = y1
        for _ in range(100):
            _, _, pred = _wlm(x1, y1, _weights(pred0, w_ld))
            if np.max(np.abs(pred - pred0)) < 1e-6:
                break
            pred0 = pred
        step1_int, _, _ = _wlm(x1, y1, _weights(pred0, w_ld))
    else:
        step1_int = intercept

    # step 2: slope on chi2 < thr2
    sub2 = chi2 < chi2_thr2
    w_ld = np.maximum(ld_score[sub2], 1)
    x = (ld_score / ld_size * sample_size)[sub2]
    y = chi2[sub2]
    yp = y - step1_int
    pred0 = y
    for _ in range(100):
        slope, pred_ni = _wlm_no_int(x, yp, _weights(pred0, w_ld))
        pred = step1_int + pred_ni
        if np.max(np.abs(pred - pred0)) < 1e-6:
            break
        pred0 = pred
    step2_h2, _ = _wlm_no_int(x, yp, _weights(pred0, w_ld))
    return float(step1_int), float(step2_h2)


def snp_ldsc(ld_score, ld_size, chi2, sample_size, blocks=200,
             intercept=None, chi2_thr1=30, chi2_thr2=np.inf):
    """Reference snp_ldsc (R/ldsc.R:66-158).

    Returns dict with int/h2 (+ int_se/h2_se when blocks is not None,
    via the delete-a-group jackknife)."""
    ld_score = np.asarray(ld_score, dtype=np.float64)
    chi2 = np.asarray(chi2, dtype=np.float64) + 1e-8
    M = len(chi2)
    sample_size = np.broadcast_to(
        np.asarray(sample_size, dtype=np.float64), (M,)).copy()

    if blocks is None:
        i, h = _ldsc_fit(ld_score, ld_size, chi2, sample_size, intercept,
                         chi2_thr1, chi2_thr2)
        return {"int": i, "h2": h}

    if np.ndim(blocks) == 0:
        nb = int(blocks)
        block_ids = np.sort(np.resize(np.arange(nb), M))
    else:
        block_ids = np.asarray(blocks)
    uniq = np.unique(block_ids)
    sizes = np.array([(block_ids == b).sum() for b in uniq], dtype=np.float64)
    h_blocks = M / sizes

    est = np.array(_ldsc_fit(ld_score, ld_size, chi2, sample_size,
                             intercept, chi2_thr1, chi2_thr2))
    deletes = np.empty((len(uniq), 2))
    for bi, b in enumerate(uniq):
        keep = block_ids != b
        deletes[bi] = _ldsc_fit(ld_score[keep], ld_size, chi2[keep],
                                sample_size[keep], intercept,
                                chi2_thr1, chi2_thr2)

    int_pv = h_blocks * est[0] - (h_blocks - 1) * deletes[:, 0]
    h2_pv = h_blocks * est[1] - (h_blocks - 1) * deletes[:, 1]
    int_J = np.sum(int_pv / h_blocks)
    h2_J = np.sum(h2_pv / h_blocks)
    return {
        "int": float(int_J),
        "int_se": float(np.sqrt(np.mean((int_pv - int_J) ** 2 / (h_blocks - 1)))),
        "h2": float(h2_J),
        "h2_se": float(np.sqrt(np.mean((h2_pv - h2_J) ** 2 / (h_blocks - 1)))),
    }


def snp_ldsc2(corr, df_beta, blocks=None, intercept=1.0, ind_beta=None,
              chi2_thr1=30, chi2_thr2=np.inf):
    """Reference snp_ldsc2 (R/ldsc.R:192-224): pulls LD scores from the
    sparse correlation matrix."""
    full_ld = corr.col_sums_sq()
    m2 = corr.shape[0]
    if ind_beta is None:
        ind_beta = np.arange(m2)
    ind_beta = np.asarray(ind_beta)
    beta = np.asarray(df_beta["beta"], dtype=np.float64)
    beta_se = np.asarray(df_beta["beta_se"], dtype=np.float64)
    n_eff = np.asarray(df_beta["n_eff"], dtype=np.float64)
    return snp_ldsc(
        ld_score=full_ld[ind_beta],
        ld_size=m2,
        chi2=(beta / beta_se) ** 2,
        sample_size=n_eff,
        blocks=blocks,
        intercept=intercept,
        chi2_thr1=chi2_thr1,
        chi2_thr2=chi2_thr2,
    )


def coef_to_liab(K_pop, K_gwas=0.5):
    """Observed->liability scale coefficient (reference R/ldsc.R:245-251)."""
    z = scipy_stats.norm.pdf(scipy_stats.norm.ppf(min(K_pop, 1 - K_pop)))
    return (K_pop * (1 - K_pop) / z) ** 2 / (K_gwas * (1 - K_gwas))
