"""Port parity: penalized regression (big_spReg, the stacking step of SCT).

The port's native CD (`native/cd_native.cpp`, a copy taking each fold's
row indices) against the JAX package's (which copies each fold's rows):
the same rows in the same order, so the fits agree to 1e-12 relative for
both families and for the Gram path; the port's Gram path matches its
residual path on one fold (tests/test_plots_penalized.py's check)."""

import numpy as np
import pytest

from bigsnpr_tpu.linalg import penalized as jpen
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.linalg import penalized as ppen

from oracle_native import private_native


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX oracle's native library, built for this test process alone
    (tests/oracle_native.py), so that no oracle falls back to numpy."""
    yield from private_native(tmp_path_factory)


def collinear(n, p, seed):
    """Nested, near-collinear columns like stacked C+T scores, a constant
    column (sd 0), and a response on a few of them."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(rng.standard_normal((n, p)), axis=1)
    X[:, 3] = 2.5
    beta = np.zeros(p)
    beta[::7] = rng.normal(size=len(beta[::7]))
    return X, X @ beta + 3.0 * rng.standard_normal(n), rng


def same_model(a, b, rtol=1e-12):
    assert a.family == b.family and a.alpha == b.alpha
    np.testing.assert_allclose(a.beta, b.beta, rtol=rtol,
                               atol=rtol * np.abs(b.beta).max())
    np.testing.assert_allclose(a.intercept, b.intercept, rtol=rtol)
    np.testing.assert_allclose(a.fold_losses, b.fold_losses, rtol=rtol)


@pytest.mark.parametrize("n,p", [(300, 120), (900, 60)])   # residual, Gram
def test_sp_linreg_matches_jax(n, p):
    X, y, _ = collinear(n, p, 1)
    kw = dict(alphas=(1.0, 0.01), K=5, nlambda=60, tol=1e-5)
    same_model(pt.big_spLinReg(X, y, **kw), jpen.big_spLinReg(X, y, **kw))


def test_sp_logreg_matches_jax():
    X, _, rng = collinear(400, 40, 2)
    X = X[:, [j for j in range(40) if j != 3]]
    eta = 0.8 * X[:, 0] / X[:, 0].std() - 0.5 * X[:, 9] / X[:, 9].std()
    y = (rng.random(400) < 1 / (1 + np.exp(-eta))).astype(float)
    kw = dict(alphas=(1.0, 0.01), K=4, nlambda=40)
    mod = pt.big_spLogReg(X, y, **kw)
    same_model(mod, jpen.big_spLogReg(X, y, **kw))
    assert mod.family == "binomial"
    assert np.all((mod.predict(X) > 0) & (mod.predict(X) < 1))


def test_sp_reg_picks_family_and_recovers_signal():
    """big_spReg infers the family from y, and the stacked fit predicts."""
    X, y, _ = collinear(600, 30, 3)
    mod = pt.big_spReg(X, y, alphas=(0.01,), K=3, nlambda=50)
    assert mod.family == "gaussian"
    assert np.corrcoef(mod.predict(X), y)[0, 1] > 0.8


def test_cd_gram_path_matches_residual_path():
    """Covariance-mode (Gram) CD == residual-mode CD on the same fold; the
    residual path reads the fold's rows of the whole matrix by index."""
    rng = np.random.default_rng(3)
    n, p = 1200, 50
    X = np.cumsum(rng.standard_normal((n, p)), axis=1)   # collinear cols
    X = (X - X.mean(0)) / X.std(0)
    beta_true = np.zeros(p)
    beta_true[::9] = rng.normal(size=len(beta_true[::9]))
    y = X @ beta_true + rng.standard_normal(n)
    rows = np.sort(rng.choice(n, 900, replace=False))
    vrows = np.setdiff1d(np.arange(n), rows)
    Xtr, Xva, ytr, yva = X[rows], X[vrows], y[rows], y[vrows]
    ntr, nv = len(rows), len(vrows)
    lam_max = np.max(np.abs(Xtr.T @ (ytr - ytr.mean()))) / ntr
    lambdas = np.exp(np.linspace(np.log(lam_max), np.log(lam_max * 1e-4),
                                 25))
    Xf = np.asfortranarray(X)
    for alpha in (1.0, 0.01):
        res = ppen.cd_path(Xf, rows, vrows, ytr, yva, lambdas, alpha, 10,
                           1e-7, 200)
        gram = ppen.cd_gram_path(
            Xtr.T @ Xtr / ntr, Xtr.T @ ytr / ntr, Xtr.mean(0), ytr.mean(),
            lambdas, alpha, Xva.T @ Xva / nv, Xva.T @ yva / nv,
            Xva.mean(0), yva.mean(), float(yva @ yva) / nv, 10, 1e-7, 200)
        assert res[3] == gram[3]          # same selected lambda
        np.testing.assert_allclose(gram[1], res[1], atol=1e-9)
        assert abs(res[0] - gram[0]) < 1e-9
        assert abs(res[2] - gram[2]) < 1e-12
        # the residual path equals the JAX package's on the copied rows
        from bigsnpr_tpu import native as jnative

        jres = jnative.cd_path(Xtr, ytr, lambdas, alpha, Xva, yva, 10, 1e-7,
                               200)
        assert jres[3] == res[3] and jres[0] == res[0]
        np.testing.assert_array_equal(jres[1], res[1])


def test_python_twin_reaches_the_native_fixed_point():
    """The numpy paths (the JAX package's fallback, kept as the twin) and
    the native active-set CD converge to the same fit at a tight tol."""
    X, y, _ = collinear(200, 15, 4)
    X = (X - X.mean(0)) / np.where(X.std(0) > 0, X.std(0), 1.0)
    rows, vrows = np.arange(150), np.arange(150, 200)
    lam_max = np.max(np.abs(X[rows].T @ (y[rows] - y[rows].mean()))) / 150
    lambdas = np.exp(np.linspace(np.log(lam_max), np.log(lam_max * 1e-2), 8))
    nat = ppen.cd_path(np.asfortranarray(X), rows, vrows, y[rows], y[vrows],
                       lambdas, 0.5, 10, 1e-12, 5000)
    twin = ppen._cd_gaussian_path(X[rows], y[rows], lambdas, 0.5, X[vrows],
                                  y[vrows], tol=1e-12, maxit=5000)
    assert nat[3] == twin[3]
    np.testing.assert_allclose(nat[1], twin[1], atol=1e-8)


def test_cd_path_refuses_rows_out_of_range():
    Xf = np.asfortranarray(np.ones((10, 3)))
    with pytest.raises(ValueError, match="out of range"):
        ppen.cd_path(Xf, np.arange(5, 11), np.arange(2), np.ones(6),
                     np.ones(2), np.ones(2), 0.5, 10, 1e-7, 10)
    with pytest.raises(ValueError, match="must match"):
        ppen.cd_path(Xf, np.arange(5), np.arange(2), np.ones(4), np.ones(2),
                     np.ones(2), 0.5, 10, 1e-7, 10)
