"""Robust statistics used by autoSVD / pcadapt outlier control.

Re-implementations of the external bigutilsr algorithms the reference
depends on (reference R/autoSVD.R:142-148, R/pcadapt.R):

- dist_ogk:     squared robust Mahalanobis distances from the OGK scatter
                (Maronna & Zamar 2002, with the Yohai-Zamar tau-scale and
                a beta=0.9 hard-rejection reweighting step, rrcov defaults)
- rollmean:     symmetric truncated rolling mean of radius `size`
- tukey_mc_up:  upper Tukey fence, skewness-adjusted via the medcouple
                (Hubert & Vandervieren 2008) and corrected for multiple
                testing at level alpha

bigutilsr is not vendored in the reference; parity is statistical, not
bit-level (the reference's own autoSVD is a heuristic outlier loop).

A copy of `bigsnpr_tpu/pca/robust.py` (host numpy / scipy): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as scipy_stats

# robustbase::scaleTau2 constants
_TAU_C1 = 4.5
_TAU_C2 = 3.0
_TAU_ES2 = 0.9247153921761315  # consistency factor E[rho_c2(Z)] under N(0,1)


def tau_scale_location(x: np.ndarray):
    """Yohai-Zamar tau-estimates of (location, scale) — robustbase scaleTau2."""
    x = np.asarray(x, dtype=np.float64)
    med = np.median(x)
    s0 = np.median(np.abs(x - med))
    if s0 == 0:
        return med, 0.0
    u = (x - med) / (_TAU_C1 * s0)
    w = np.where(np.abs(u) <= 1, (1 - u**2) ** 2, 0.0)
    mu = np.sum(w * x) / np.sum(w)
    rho = np.minimum(((x - mu) / s0) ** 2, _TAU_C2**2)
    sigma2 = s0**2 * np.mean(rho) / _TAU_ES2
    return mu, np.sqrt(sigma2)


def covrob_ogk(X: np.ndarray, niter: int = 2, beta: float = 0.9):
    """OGK robust (location, scatter) with reweighting (rrcov CovOgk defaults).

    X: (n, p). Returns (center (p,), cov (p, p)).
    """
    X = np.asarray(X, dtype=np.float64)
    n, p = X.shape

    def one_step(Z):
        d = np.array([tau_scale_location(Z[:, j])[1] for j in range(p)])
        d = np.where(d == 0, 1e-30, d)
        Y = Z / d
        U = np.eye(p)
        for j in range(p):
            for k in range(j + 1, p):
                sj = tau_scale_location(Y[:, j] + Y[:, k])[1]
                sk = tau_scale_location(Y[:, j] - Y[:, k])[1]
                U[j, k] = U[k, j] = 0.25 * (sj**2 - sk**2)
        _, E = np.linalg.eigh(U)
        E = E[:, ::-1]
        V = Y @ E                    # principal directions in scaled space
        A = d[:, None] * E           # back-transform
        return V, A

    V, A1 = one_step(X)
    if niter >= 2:
        V, A2 = one_step(V)
        A = A1 @ A2
    else:
        A = A1

    mus = np.empty(V.shape[1])
    sig = np.empty(V.shape[1])
    for j in range(V.shape[1]):
        mus[j], sig[j] = tau_scale_location(V[:, j])
    cov0 = A @ np.diag(sig**2) @ A.T
    center0 = A @ mus

    # hard-rejection reweighting (rrcov CovOgk beta = 0.9)
    Zc = V - mus
    with np.errstate(divide="ignore"):
        d2 = np.sum((Zc / np.where(sig == 0, 1e-30, sig)) ** 2, axis=1)
    cutoff = scipy_stats.chi2.ppf(beta, p) * np.median(d2) / scipy_stats.chi2.ppf(0.5, p)
    wt = d2 <= cutoff
    Xw = X[wt]
    center = Xw.mean(axis=0)
    cov = (Xw - center).T @ (Xw - center) / wt.sum()
    return center, cov


def dist_ogk(X: np.ndarray) -> np.ndarray:
    """Squared robust Mahalanobis distances (bigutilsr::dist_ogk)."""
    X = np.asarray(X, dtype=np.float64)
    center, cov = covrob_ogk(X)
    L = np.linalg.cholesky(cov)
    z = np.linalg.solve(L, (X - center).T)
    return np.sum(z**2, axis=0)


def rollmean(x: np.ndarray, size: int) -> np.ndarray:
    """Symmetric truncated rolling mean of radius `size` (bigutilsr::rollmean)."""
    x = np.asarray(x, dtype=np.float64)
    if size <= 0 or len(x) == 0:
        return x.copy()
    n = len(x)
    csum = np.concatenate([[0.0], np.cumsum(x)])
    i = np.arange(n)
    lo = np.maximum(i - size, 0)
    hi = np.minimum(i + size + 1, n)
    return (csum[hi] - csum[lo]) / (hi - lo)


def medcouple(x: np.ndarray, max_n: int = 5000, seed: int = 0) -> float:
    """Medcouple robust skewness (Brys, Hubert & Struyf 2004), O(k^2) on a
    deterministic subsample when len(x) > max_n."""
    x = np.asarray(x, dtype=np.float64)
    x = x[~np.isnan(x)]
    if len(x) > max_n:
        rng = np.random.default_rng(seed)
        x = rng.choice(x, max_n, replace=False)
    med = np.median(x)
    lo = x[x <= med]
    hi = x[x >= med]
    zlo = lo[None, :] - med       # <= 0
    zhi = hi[:, None] - med       # >= 0
    num = zhi + zlo
    den = zhi - zlo
    with np.errstate(invalid="ignore", divide="ignore"):
        h = num / den
    # ties at the median: h = sign convention (robustbase mc)
    ties = den == 0
    if ties.any():
        nlo = len(lo)
        # indices among tied values: standard kernel sign(p + q - 1 - k)
        tied_lo = np.nonzero(lo == med)[0]
        tied_hi = np.nonzero(hi == med)[0]
        k = len(tied_lo)  # == number of values equal to the median on lo side
        for a, ia in enumerate(tied_hi):
            for b, ib in enumerate(tied_lo):
                h[ia, ib] = np.sign((len(tied_hi) - 1 - a) - b)
    return float(np.median(h))


def tukey_mc_up(x: np.ndarray, alpha: float = 0.05, coef: float | None = None,
                a: float = -4.0, b: float = 3.0) -> float:
    """Upper outlier threshold: Q3 + coef * exp(mc-adjustment) * IQR
    (bigutilsr::tukey_mc_up semantics: Hubert-Vandervieren skew adjustment,
    coefficient calibrated for multiple testing at level alpha)."""
    x = np.asarray(x, dtype=np.float64)
    x = x[~np.isnan(x)]
    q1, q3 = np.quantile(x, [0.25, 0.75])
    iqr = q3 - q1
    if coef is None:
        # calibrate so that, under normality, P(max of n exceeds fence) ~ alpha
        n = len(x)
        q_alpha = scipy_stats.norm.isf(alpha / (2 * n))
        q75 = scipy_stats.norm.ppf(0.75)
        coef = (q_alpha - q75) / (2 * q75)
    mc = medcouple(x)
    adj = np.exp(b * mc) if mc >= 0 else np.exp(-a * mc)
    return float(q3 + coef * adj * iqr)
