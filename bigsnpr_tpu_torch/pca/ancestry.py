"""Ancestry proportion estimation from allele frequencies.

Reference: snp_ancestry_summary (R/ancestry-summary.R:31-74): project
frequencies onto reference-PC loadings with shrinkage correction, solve a
simplex-constrained QP, guardrails on prediction correlation.

A copy of `bigsnpr_tpu/pca/ancestry.py` (host numpy, scipy SLSQP).
"""

from __future__ import annotations

import numpy as np
from scipy import optimize


def _near_pd(A: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Nearest positive-definite (eigenvalue clipping, Matrix::nearPD spirit)."""
    A = (A + A.T) / 2
    w, V = np.linalg.eigh(A)
    w = np.maximum(w, eps * np.max(np.abs(w)))
    return (V * w) @ V.T


def snp_ancestry_summary(freq, info_freq_ref, projection, correction,
                         min_cor: float = 0.4, sum_to_one: bool = True):
    """Returns (proportions (K,), {'cor_each', 'cor_pred'})."""
    freq = np.asarray(freq, dtype=np.float64)
    X0 = np.asarray(info_freq_ref, dtype=np.float64)
    P = np.asarray(projection, dtype=np.float64)
    correction = np.asarray(correction, dtype=np.float64)
    assert not (np.isnan(freq).any() or np.isnan(X0).any() or np.isnan(P).any())
    assert len(freq) == X0.shape[0] == P.shape[0]
    assert len(correction) == P.shape[1]

    cor_each = np.array([np.corrcoef(X0[:, k], freq)[0, 1]
                         for k in range(X0.shape[1])])
    if cor_each.mean() < -0.2:
        raise ValueError("Frequencies seem all reversed; switch reference allele?")

    X = P.T @ X0                      # (K_pc, n_pop)
    y = (P.T @ freq) * correction

    D = _near_pd(X.T @ X)
    d = y @ X
    npop = X.shape[1]

    # QP: min 1/2 w^T D w - d^T w  s.t.  sum(w) <= 1 (== 1 if sum_to_one), w >= 0
    cons = []
    if sum_to_one:
        cons.append({"type": "eq", "fun": lambda w: w.sum() - 1,
                     "jac": lambda w: np.ones(npop)})
    else:
        cons.append({"type": "ineq", "fun": lambda w: 1 - w.sum(),
                     "jac": lambda w: -np.ones(npop)})

    def obj(w):
        return 0.5 * w @ D @ w - d @ w

    def grad(w):
        return D @ w - d

    w0 = np.full(npop, 1.0 / npop)
    res = optimize.minimize(obj, w0, jac=grad, method="SLSQP",
                            bounds=[(0, None)] * npop, constraints=cons,
                            options={"maxiter": 500, "ftol": 1e-14})
    sol = np.maximum(res.x, 0)

    pred = X0 @ sol
    cor_pred = float(np.corrcoef(pred, freq)[0, 1])
    if cor_pred < min_cor:
        raise ValueError(f"Correlation between frequencies is too low: "
                         f"{cor_pred:.3f}; check matching between variants.")
    import warnings

    if cor_pred < 0.99:
        warnings.warn("The solution does not perfectly match the frequencies.")
    return np.round(sol, 7), {"cor_each": cor_each, "cor_pred": cor_pred}
