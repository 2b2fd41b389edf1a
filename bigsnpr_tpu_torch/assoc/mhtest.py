"""mhtest objects: GWAS score containers with transfo/predict attributes,
and genomic control.

Reference: R/man-qq-gc.R. The mhtest contract: `transfo(score)` maps raw
scores to the test scale; `predict(transfo(score))` returns log10
p-values (reference getLambdaGC, R/man-qq-gc.R:97-108).

A copy of `bigsnpr_tpu/assoc/mhtest.py` (host numpy / scipy) without its
plots, `snp_qq` and `snp_manhattan` (not ported yet).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
from scipy import optimize, stats as scipy_stats


def chisq_log10_predictor(df: int) -> Callable:
    def predict(xtr):
        return scipy_stats.chi2.logsf(xtr, df=df) / np.log(10)

    return predict


@dataclass
class MHTest:
    """score + transfo + predict (log10 p-values)."""

    score: np.ndarray
    transfo: Callable = field(default=lambda x: x)
    predict: Callable = field(default=chisq_log10_predictor(1))

    def lpval(self) -> np.ndarray:
        """log10 p-values."""
        return self.predict(self.transfo(self.score))

    def pval(self) -> np.ndarray:
        return np.power(10.0, self.lpval())


def get_lambda_gc(gwas: MHTest, tol: float = 1e-8) -> float:
    """lambda_GC via uniroot on the median (reference R/man-qq-gc.R:97-108)."""
    xtr = gwas.transfo(gwas.score[~np.isnan(gwas.score)])
    MEDIAN = np.log10(0.5)

    def f(x):
        return gwas.predict(x) - MEDIAN

    lo, hi = float(np.min(xtr)), float(np.max(xtr))
    root = optimize.brentq(f, lo, hi, xtol=tol)
    return float(np.median(xtr) / root)


def snp_gc(gwas: MHTest) -> MHTest:
    """Genomic control: divide the transfo by lambda_GC
    (reference snp_gc, R/man-qq-gc.R:151-165)."""
    lam = get_lambda_gc(gwas)
    old_transfo = gwas.transfo
    return MHTest(score=gwas.score,
                  transfo=lambda x, _f=old_transfo, _l=lam: _f(x) / _l,
                  predict=gwas.predict)


def mhtest_from_gwas(gwas, n: int, n_covar: int = 0,
                     family: str = "gaussian") -> MHTest:
    """Wrap a big_univLinReg/big_univLogReg result as an mhtest
    (bigstatsr attaches these attrs to its GWAS outputs).

    Linear: t-scores with df = n - n_covar - 2 (Student predict);
    logistic: z-scores (normal predict). transfo = abs.
    """
    score = np.asarray(gwas["score"], dtype=np.float64)
    if family == "gaussian":
        df = n - n_covar - 2

        def predict(xtr):
            return (scipy_stats.t.logsf(xtr, df=df) + np.log(2)) / np.log(10)
    else:
        def predict(xtr):
            return (scipy_stats.norm.logsf(xtr) + np.log(2)) / np.log(10)

    return MHTest(score=score, transfo=np.abs, predict=predict)
