"""Penalized (sparse) linear/logistic regression with CMSA (port of
`bigsnpr_tpu/linalg/penalized.py`).

The bigstatsr surface the reference stacks C+T scores with
(big_spLogReg / big_spLinReg, used at reference R/SCT.R:266-304):
elastic-net path fit per cross-validation fold with early stopping on the
held fold ("Cross-Model Selection and Averaging", Privé et al. 2019),
final coefficients = average over folds; alpha grid-searched.

Cyclic coordinate descent on standardized features in float64, warm-started
along a decreasing lambda path, in `native/cd_native.cpp` (a copy of the
JAX package's native source, built with g++ at first use; a failed build
raises): the residual paths for both families and, for a gaussian fit with
n >= 4p, the covariance-mode (Gram) path. The K folds share one
column-major standardized matrix and pass the native code their row
indices, where the JAX package copies each fold's rows; the rows are
visited in the same order, so the fits are the same. The numpy paths
`_cd_gaussian_path` / `_cd_binomial_path` are the JAX package's fallback,
kept as the tests' reference.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from bigsnpr_tpu_torch.ops import cuda_build

SOURCE = cuda_build.PKG / "native" / "cd_native.cpp"


def _bind(lib):
    p, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    for name in ("cd_gaussian_path", "cd_binomial_path"):
        fn = getattr(lib, name)
        fn.argtypes = [p, i64, p, p, i64, i64, p, i64, f64, p, p, i64, i64,
                       f64, i64, p, p, p, p]
        fn.restype = ctypes.c_int
    lib.cd_gaussian_gram_path.argtypes = [p, p, p, f64, i64, p, i64, f64, p,
                                          p, p, f64, f64, i64, f64, i64, p,
                                          p, p, p]
    lib.cd_gaussian_gram_path.restype = ctypes.c_int


def _lib():
    return cuda_build.load(SOURCE, _bind)


def _soft(x, t):
    return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)


def _cd_gaussian_path(X, y, lambdas, alpha, Xval, yval, n_abort=10,
                      tol=1e-7, maxit=200):
    n, p = X.shape
    beta = np.zeros(p)
    intercept = y.mean()
    r = y - intercept
    xsq = (X**2).sum(axis=0) / n
    best = (np.inf, None, None, 0)
    for li, lam in enumerate(lambdas):
        l1, l2 = lam * alpha, lam * (1 - alpha)
        for _ in range(maxit):
            max_d = 0.0
            for j in range(p):
                bj = beta[j]
                rho = X[:, j] @ r / n + xsq[j] * bj
                new = _soft(rho, l1) / (xsq[j] + l2)
                if new != bj:
                    r -= X[:, j] * (new - bj)
                    beta[j] = new
                    max_d = max(max_d, abs(new - bj))
            di = r.mean()
            if di != 0:
                intercept += di
                r -= di
            if max_d < tol:
                break
        pred_val = Xval @ beta + intercept
        loss = np.mean((yval - pred_val) ** 2)
        if loss < best[0]:
            best = (loss, beta.copy(), intercept, li)
        if li - best[3] >= n_abort:
            break
    return best


def _cd_binomial_path(X, y, lambdas, alpha, Xval, yval, n_abort=10,
                      tol=1e-6, maxit=50):
    """IRLS + CD (glmnet-style quadratic approximation)."""
    n, p = X.shape
    beta = np.zeros(p)
    intercept = np.log(max(y.mean(), 1e-9) / max(1 - y.mean(), 1e-9))
    best = (np.inf, None, None, 0)
    for li, lam in enumerate(lambdas):
        l1, l2 = lam * alpha, lam * (1 - alpha)
        for _ in range(maxit):
            eta = intercept + X @ beta
            mu = 1.0 / (1.0 + np.exp(-eta))
            w = np.maximum(mu * (1 - mu), 1e-6)
            z = eta + (y - mu) / w
            max_d = 0.0
            r = z - eta
            wsum = w.sum()
            for j in range(p):
                bj = beta[j]
                wxx = (w * X[:, j] ** 2).sum() / n
                rho = (w * X[:, j] * r).sum() / n + wxx * bj
                new = _soft(rho, l1) / (wxx + l2)
                if new != bj:
                    r -= X[:, j] * (new - bj)
                    beta[j] = new
                    max_d = max(max_d, abs(new - bj))
            di = (w * r).sum() / wsum
            intercept += di
            r -= di
            if max_d < tol and abs(di) < tol:
                break
        eta_val = intercept + Xval @ beta
        mu_val = np.clip(1.0 / (1.0 + np.exp(-eta_val)), 1e-9, 1 - 1e-9)
        loss = -np.mean(yval * np.log(mu_val) + (1 - yval) * np.log(1 - mu_val))
        if loss < best[0]:
            best = (loss, beta.copy(), intercept, li)
        if li - best[3] >= n_abort:
            break
    return best


def cd_path(Xf, rows, vrows, y, yval, lambdas, alpha, n_abort, tol, maxit,
            family="gaussian"):
    """Native elastic-net CD path on the rows `rows` of the column-major
    matrix Xf, validated on `vrows` (both ascending). Returns (loss, beta,
    intercept, best_li), (inf, None, None, 0) when no lambda gave a
    finite loss, as the JAX package's `native.cd_path` does."""
    lib = _lib()
    if not Xf.flags.f_contiguous or Xf.dtype != np.float64:
        raise ValueError("Xf must be a Fortran-ordered float64 matrix")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    vrows = np.ascontiguousarray(vrows, dtype=np.int64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    yval = np.ascontiguousarray(yval, dtype=np.float64)
    lambdas = np.ascontiguousarray(lambdas, dtype=np.float64)
    if len(y) != len(rows) or len(yval) != len(vrows):
        raise ValueError("y and yval must match rows and vrows")
    for r in (rows, vrows):
        if len(r) and (r.min() < 0 or r.max() >= Xf.shape[0]):
            raise ValueError("row index out of range")
    p = Xf.shape[1]
    beta = np.zeros(p)
    intercept, loss = np.zeros(1), np.zeros(1)
    li = np.zeros(1, dtype=np.int64)
    rc = getattr(lib, f"cd_{family}_path")(
        Xf.ctypes.data, Xf.shape[0], rows.ctypes.data, y.ctypes.data,
        len(rows), p, lambdas.ctypes.data, len(lambdas), float(alpha),
        vrows.ctypes.data, yval.ctypes.data, len(vrows), int(n_abort),
        float(tol), int(maxit), beta.ctypes.data, intercept.ctypes.data,
        loss.ctypes.data, li.ctypes.data)
    if rc != 0:
        return (np.inf, None, None, 0)
    return (float(loss[0]), beta, float(intercept[0]), int(li[0]))


def cd_gram_path(G, xty, c, ybar, lambdas, alpha, Gval, xvty, cv, yvbar,
                 yv2, n_abort, tol, maxit):
    """Covariance-mode gaussian CD path against precomputed Grams
    (O(p^2) per pass, n-independent). Returns (loss, beta, intercept,
    best_li)."""
    lib = _lib()
    G = np.ascontiguousarray(G, dtype=np.float64)
    Gval = np.ascontiguousarray(Gval, dtype=np.float64)
    xty = np.ascontiguousarray(xty, dtype=np.float64)
    xvty = np.ascontiguousarray(xvty, dtype=np.float64)
    c = np.ascontiguousarray(c, dtype=np.float64)
    cv = np.ascontiguousarray(cv, dtype=np.float64)
    lambdas = np.ascontiguousarray(lambdas, dtype=np.float64)
    p = G.shape[0]
    beta = np.zeros(p)
    intercept, loss = np.zeros(1), np.zeros(1)
    li = np.zeros(1, dtype=np.int64)
    rc = lib.cd_gaussian_gram_path(
        G.ctypes.data, xty.ctypes.data, c.ctypes.data, float(ybar), p,
        lambdas.ctypes.data, len(lambdas), float(alpha),
        Gval.ctypes.data, xvty.ctypes.data, cv.ctypes.data, float(yvbar),
        float(yv2), int(n_abort), float(tol), int(maxit),
        beta.ctypes.data, intercept.ctypes.data, loss.ctypes.data,
        li.ctypes.data)
    if rc != 0:
        return (np.inf, None, None, 0)
    return (float(loss[0]), beta, float(intercept[0]), int(li[0]))


@dataclass
class SpRegModel:
    beta: np.ndarray          # averaged over folds, on original feature scale
    intercept: float
    family: str
    alpha: float
    fold_losses: np.ndarray

    def predict(self, X):
        eta = X @ self.beta + self.intercept
        if self.family == "binomial":
            return 1.0 / (1.0 + np.exp(-eta))
        return eta


def big_spReg(X, y, family=None, alphas=(1.0, 0.01, 0.0001), K=10,
              nlambda=200, lambda_min_ratio=1e-4, n_abort=10, seed=1,
              covar=None, tol=None, maxit=None) -> SpRegModel:
    """CMSA elastic-net (big_spLogReg/big_spLinReg equivalent).

    covar columns, if given, are appended (penalized, as in the JAX
    package; the stacking use-case passes none)."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if covar is not None:
        X = np.column_stack([X, np.asarray(covar, dtype=np.float64)])
    n, p = X.shape
    if family is None:
        family = "binomial" if len(np.unique(y)) == 2 else "gaussian"

    # standardize features (CD operates on standardized scale)
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd[sd == 0] = 1.0
    Xs = (X - mu) / sd
    del X

    yc = y - y.mean() if family == "gaussian" else y
    lam_max = np.max(np.abs(Xs.T @ (yc - yc.mean()))) / n
    lam_max = max(lam_max, 1e-6)

    rng = np.random.default_rng(seed)
    folds = rng.permutation(n) % K

    tol_d, maxit_d = ((1e-6, 50) if family == "binomial" else (1e-7, 200))
    tol = tol_d if tol is None else float(tol)
    maxit = maxit_d if maxit is None else int(maxit)

    # covariance-mode (Gram) CD when n >> p: per-fold Grams are one
    # dgemm each, then every CD pass costs O(p^2) independent of n
    # (glmnet's "covariance updating"; same fixed point and selection)
    gram_folds = None
    if family == "gaussian" and n >= 4 * p:
        S_full = Xs.T @ Xs
        sum_full = Xs.sum(axis=0)
        xty_full = Xs.T @ y
        ysum_full = y.sum()
        gram_folds = []
        for k in range(K):
            vmask = folds == k
            Xv = Xs[vmask]
            yv = y[vmask]
            nv = len(yv)
            ntr = n - nv
            Sv = Xv.T @ Xv
            sv = Xv.sum(axis=0)
            xvy = Xv.T @ yv
            gram_folds.append(dict(
                G=(S_full - Sv) / ntr, xty=(xty_full - xvy) / ntr,
                c=(sum_full - sv) / ntr, ybar=(ysum_full - yv.sum()) / ntr,
                Gval=Sv / nv, xvty=xvy / nv, cv=sv / nv,
                yvbar=yv.mean(), yv2=float(yv @ yv) / nv))
    else:
        Xs = np.asfortranarray(Xs)         # one copy: columns contiguous
        rows = [np.nonzero(folds != k)[0] for k in range(K)]
        vrows = [np.nonzero(folds == k)[0] for k in range(K)]

    def fit_fold(k, lambdas, alpha):
        if gram_folds is not None:
            f = gram_folds[k]
            return cd_gram_path(
                f["G"], f["xty"], f["c"], f["ybar"], lambdas, alpha,
                f["Gval"], f["xvty"], f["cv"], f["yvbar"], f["yv2"],
                n_abort, tol, maxit)
        return cd_path(Xs, rows[k], vrows[k], y[rows[k]], y[vrows[k]],
                       lambdas, alpha, n_abort, tol, maxit, family=family)

    # every (alpha, fold) fit in one pool: the JAX package waits for each
    # alpha's folds before the next alpha starts; the fits are the same
    paths = {alpha: np.exp(np.linspace(
        np.log(lam_max / max(alpha, 1e-3)),
        np.log(lam_max / max(alpha, 1e-3) * lambda_min_ratio), nlambda))
        for alpha in alphas}
    workers = min(K * len(paths), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {alpha: [pool.submit(fit_fold, k, lambdas, alpha)
                           for k in range(K)]
                   for alpha, lambdas in paths.items()}
        all_fits = {alpha: [f.result() for f in fs]
                    for alpha, fs in futures.items()}
    results = {}
    for alpha, fits in all_fits.items():
        fold_betas, fold_ints, fold_losses = [], [], []
        for loss, beta, intercept, _ in fits:
            if beta is None:
                beta, intercept = np.zeros(p), 0.0
            fold_betas.append(beta)
            fold_ints.append(intercept)
            fold_losses.append(loss)
        results[alpha] = (np.mean(fold_losses), np.mean(fold_betas, axis=0),
                          np.mean(fold_ints), np.asarray(fold_losses))

    best_alpha = min(results, key=lambda a: results[a][0])
    _, beta_s, int_s, losses = results[best_alpha]
    # back to original scale
    beta = beta_s / sd
    intercept = float(int_s - (mu / sd) @ beta_s)
    return SpRegModel(beta=beta, intercept=intercept, family=family,
                      alpha=best_alpha, fold_losses=losses)


def big_spLinReg(X, y, **kw) -> SpRegModel:
    return big_spReg(X, y, family="gaussian", **kw)


def big_spLogReg(X, y, **kw) -> SpRegModel:
    return big_spReg(X, y, family="binomial", **kw)
