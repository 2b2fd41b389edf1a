"""Univariate GWAS regressions (the bigstatsr big_univLinReg /
big_univLogReg surface the reference builds PGS pipelines on,
e.g. reference tests/testthat/test-6-PRS.R:20, R/ldsc.R examples).

Linear: residualize y and every genotype column against the covariate
block once, so all per-SNP slopes and SEs come from one operator cprod of
[yr | Q] (kernel K1 on CUDA, K7 under `config.pallas_mxu = "split2"`,
K6 under "int8") plus column stats. Logistic: a batched IRLS in torch
with a fixed iteration count, all variants of a block at once.

Results are dicts of numpy columns {"estim", "std.err", "score"} (the
JAX package returns pandas DataFrames with the same columns).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import stats as scipy_stats

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.unpack import unpack_dosage
from bigsnpr_tpu_torch.ops.blocks import pick_block
from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator
from bigsnpr_tpu_torch.ops.stats import snp_colstats


def _design(n, covar):
    return np.ones((n, 1)) if covar is None else np.column_stack(
        [np.ones(n), np.asarray(covar)])


def big_univLinReg(pack, y, covar=None, ind_row=None, block=None,
                   device=None) -> dict:
    """Per-SNP linear regression y ~ x + covariates, NA dosages
    mean-imputed per variant.

    With mean-imputed NAs, per-SNP OLS after projecting out [1 | covar]
    needs only X̃ᵀ[yr | Q] (X̃ = x - mean through the operator's center,
    NA -> 0) and the centered SSQ from colstats. ind_row is masked on the
    device (the pack is not subset). `block` is accepted for the JAX
    package's signature."""
    from bigsnpr_tpu_torch.linalg.randomsvd import _cached_op

    dev = config.resolve_device(device)
    n = pack.n if ind_row is None else len(ind_row)
    m = pack.m
    y = np.asarray(y, dtype=np.float64)
    if len(y) != n:
        raise ValueError(f"big_univLinReg: len(y) = {len(y)} != {n} samples")
    Q, _ = np.linalg.qr(_design(n, covar))
    yr = y - Q @ (Q.T @ y)
    K = Q.shape[1]

    st = snp_colstats(pack, ind_row=ind_row, device=dev)
    nona = np.maximum(np.asarray(st["nona"], np.float64), 1.0)
    mean = np.asarray(st["sumX"], np.float64) / nona
    sxx_tot = np.asarray(st["denoX"], np.float64)  # sum (x - mean)^2

    op = _cached_op(pack, GenoOperator, mean, np.ones(m), ind_row, None,
                    device=dev)
    V = np.column_stack([yr, Q]).astype(np.float32)    # (n, K+1)
    B = np.asarray(op.cprod(V), dtype=np.float64)      # (m, K+1)
    b_yr = B[:, 0]
    xq = B[:, 1:]                                      # Qᵀx̃ per SNP
    with np.errstate(divide="ignore", invalid="ignore"):
        sxx_r = sxx_tot - np.sum(xq * xq, axis=1)
        beta = b_yr / sxx_r
        df = n - K - 1
        rss = yr @ yr - beta * b_yr
        se = np.sqrt(rss / df / sxx_r)
        score = beta / se
    return {"estim": beta, "std.err": se, "score": score}


def _logreg_block(x, y, C, niter):
    """IRLS for a block of variants at once: x (b, n) mean-imputed
    dosages, y (n,), C (n, K) -> (beta, se) of the last coefficient.
    Newton steps from 0 with H the Hessian of the last step's start, as
    the JAX package does; H is assembled from its blocks
    [[CᵀWC, CᵀWx], [xᵀWC, xᵀWx]] so no (b, n, K+1) design is built."""
    b, n = x.shape
    K = C.shape[1]
    CC = (C[:, :, None] * C[:, None, :]).reshape(n, K * K)
    coef = torch.zeros((b, K + 1), dtype=x.dtype, device=x.device)
    H = None
    for _ in range(niter):
        eta = coef[:, :K] @ C.T + coef[:, K:] * x
        mu = torch.sigmoid(eta)
        w = mu * (1 - mu) + 1e-12
        wx = w * x
        H = torch.empty((b, K + 1, K + 1), dtype=x.dtype, device=x.device)
        H[:, :K, :K] = (w @ CC).reshape(b, K, K)
        H[:, :K, K] = wx @ C
        H[:, K, :K] = H[:, :K, K]
        H[:, K, K] = (wx * x).sum(1)
        r = y - mu
        g = torch.cat([r @ C, (r * x).sum(1, keepdim=True)], dim=1)
        coef = coef + torch.linalg.solve(H, g)
    cov = torch.linalg.inv(H)
    return coef[:, K], torch.sqrt(cov[:, K, K])


def big_univLogReg(pack, y01, covar=None, ind_row=None, block=None,
                   niter: int = 8, device=None) -> dict:
    """Per-SNP logistic regression (bigstatsr big_univLogReg surface),
    by IRLS with `niter` Newton steps, in float64 on the device."""
    dev = config.resolve_device(device)
    n = pack.n if ind_row is None else len(ind_row)
    y01 = np.asarray(y01, dtype=np.float64)
    if len(y01) != n:
        raise ValueError(f"big_univLogReg: len(y01) = {len(y01)} != {n}")
    C = torch.as_tensor(_design(n, covar), dtype=torch.float64, device=dev)
    y = torch.as_tensor(y01, dtype=torch.float64, device=dev)
    ir = (None if ind_row is None else
          torch.as_tensor(np.asarray(ind_row), dtype=torch.long, device=dev))
    packed = pack.device_packed(dev)
    block = block or max(8, pick_block(n) // 8)
    beta = np.empty(pack.m)
    se = np.empty(pack.m)
    for j0 in range(0, pack.m, block):
        d, na = unpack_dosage(packed[j0:j0 + block], pack.n,
                              dtype=torch.float64)
        if ir is not None:
            d, na = d[:, ir], na[:, ir]
        cnt = (~na).sum(1)
        mean = d.sum(1) / torch.clamp(cnt, min=1)
        x = torch.where(na, mean[:, None], d)
        b, s = _logreg_block(x, y, C, niter)
        beta[j0:j0 + len(x)] = b.cpu().numpy()
        se[j0:j0 + len(x)] = s.cpu().numpy()
    return {"estim": beta, "std.err": se, "score": beta / se}


def gwas_pvalues(gwas, log10: bool = False) -> np.ndarray:
    """Two-sided p-values from z-scores (the reference's predict.mhtest)."""
    z2 = (np.asarray(gwas["estim"]) / np.asarray(gwas["std.err"])) ** 2
    lp = scipy_stats.chi2.logsf(z2, df=1) / np.log(10)
    return lp if log10 else np.power(10.0, lp)
