"""mhtest objects: GWAS score containers with transfo/predict attributes,
and genomic control.

Reference: R/man-qq-gc.R. The mhtest contract: `transfo(score)` maps raw
scores to the test scale; `predict(transfo(score))` returns log10
p-values (reference getLambdaGC, R/man-qq-gc.R:97-108).

A copy of `bigsnpr_tpu/assoc/mhtest.py` (host numpy / scipy), with its
plots `snp_qq` and `snp_manhattan`, which import matplotlib when called.
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


def snp_qq(gwas: MHTest, lambdaGC: bool = True, ax=None):
    """QQ plot of -log10 p-values (reference snp_qq)."""
    import matplotlib.pyplot as plt

    lp = -gwas.lpval()
    lp = lp[~np.isnan(lp)]
    n = len(lp)
    expected = -np.log10((np.arange(1, n + 1) - 0.5) / n)
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(expected, np.sort(lp)[::-1], ".", ms=3)
    lim = max(expected.max(), 1)
    ax.plot([0, lim], [0, lim], "r--")
    ax.set_xlabel("Expected $-\\log_{10}(p)$")
    ax.set_ylabel("Observed $-\\log_{10}(p)$")
    title = "Q-Q plot"
    if lambdaGC:
        title += f"  ($\\lambda_{{GC}}$ = {get_lambda_gc(gwas):.4g})"
    ax.set_title(title)
    return ax


def snp_manhattan(gwas: MHTest, infos_chr, infos_pos,
                  colors=("black", "grey"), dist_sep_chrs: float = 1e7,
                  ind_highlight=(), col_highlight="red", npoints=None,
                  ax=None):
    """Manhattan plot (reference snp_manhattan, R/man-qq-gc.R:38-93)."""
    import matplotlib.pyplot as plt

    infos_chr = np.asarray(infos_chr)
    infos_pos = np.asarray(infos_pos)
    ord_ = np.lexsort((infos_pos, infos_chr))
    chrs, pos = infos_chr[ord_], infos_pos[ord_]
    lp = -gwas.lpval()[ord_]

    all_chr = np.unique(chrs)
    offset = 0.0
    all_pos = np.empty(len(pos))
    label_pos = []
    for c in all_chr:
        sel = chrs == c
        p = pos[sel] + offset + dist_sep_chrs
        all_pos[sel] = p
        label_pos.append((p.min() + p.max()) / 2)
        offset = p[-1]

    col_cycle = np.resize(np.asarray(colors, dtype=object), len(all_chr))
    point_colors = col_cycle[np.searchsorted(all_chr, chrs)]
    hl = np.zeros(len(pos), dtype=bool)
    hl[np.asarray(ind_highlight, dtype=int)] = True
    point_colors = np.where(hl[ord_], col_highlight, point_colors)

    if npoints is not None:
        keep = np.argsort(-lp)[:npoints]
    else:
        keep = np.arange(len(lp))
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    ax.scatter(all_pos[keep], lp[keep], c=point_colors[keep], s=4)
    ax.set_xticks(label_pos)
    ax.set_xticklabels(all_chr)
    ax.set_xlabel("Chromosome")
    ax.set_ylabel("$-\\log_{10}(p)$")
    ax.set_title("Manhattan Plot")
    return ax


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
