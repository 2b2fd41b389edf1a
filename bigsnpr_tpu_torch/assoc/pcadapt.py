"""pcadapt outlier scan and its K-regression (port of
`bigsnpr_tpu/assoc/pcadapt.py`).

Reference: snp_pcadapt / bed_pcadapt (R/pcadapt.R:3-79) on top of
multLinReg (src/multLinReg.cpp:9-86): K simultaneous per-SNP univariate
regressions of PC loadings on genotype, NA-aware t-scores -> robust
Mahalanobis (dist_ogk) -> chi2_K log-p, wrapped with genomic control.

The JAX package's blocked XLA GEMM is torch ops here: a decoded block of
variants against [U, U^2, 1], its products at `config.matmul_precision`
(`ops/precision.py`), the same formulas in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.assoc.mhtest import MHTest, chisq_log10_predictor, snp_gc
from bigsnpr_tpu_torch.core.unpack import unpack_dosage
from bigsnpr_tpu_torch.ops import precision
from bigsnpr_tpu_torch.ops.blocks import pick_block
from bigsnpr_tpu_torch.pca.robust import dist_ogk


def _mult_lin_reg_block(packed, n, U, Usq, prec):
    """t-scores of U_k ~ x for a block of variants (reference
    src/multLinReg.cpp:9-60), float32, the products at `prec`."""
    d, na = unpack_dosage(packed, n)            # (block, n), NA -> 0
    mask = (~na).to(torch.float32)
    nona = mask.sum(dim=1)
    xSum = d.sum(dim=1)
    xxSum = (d * d).sum(dim=1)
    xy = precision.mm(d, U, prec)               # (block, K)
    ySum = precision.mm(mask, U, prec)
    yySum = precision.mm(mask, Usq, prec)
    num = xy - xSum[:, None] * ySum / nona[:, None]
    deno_x = xxSum - xSum ** 2 / nona
    deno_y = yySum - ySum ** 2 / nona[:, None]
    deno = deno_x[:, None] * deno_y - num * num
    bad = (deno <= 0) | (nona[:, None] < 2)
    one = torch.ones((), dtype=deno.dtype, device=deno.device)
    t = num * torch.sqrt(torch.where(
        bad, torch.zeros_like(deno),
        (nona[:, None] - 2) / torch.where(deno == 0, one, deno)))
    return torch.where(bad, torch.full_like(t, float("nan")), t)


def mult_lin_reg(pack, U, ind_row=None, block=None, device=None) -> np.ndarray:
    """(m, K) t-scores; the rows ind_row are repacked on the device."""
    dev = config.resolve_device(device)
    sub = (pack if ind_row is None
           else pack.subset(ind_row=np.asarray(ind_row), device=dev))
    n, m = sub.n, sub.m
    U = np.atleast_2d(np.asarray(U, dtype=np.float64))
    if U.shape[0] != n:
        U = U.T
    assert U.shape[0] == n
    block = block or pick_block(n)
    prec = precision.resolve()
    Ut = torch.as_tensor(U, dtype=torch.float32, device=dev)
    Usq = Ut * Ut
    packed = sub.device_packed(dev)
    out = torch.empty((m, Ut.shape[1]), dtype=torch.float32, device=dev)
    for j0 in range(0, m, block):
        out[j0:j0 + block] = _mult_lin_reg_block(packed[j0:j0 + block], n,
                                                 Ut, Usq, prec)
    return out.cpu().numpy().astype(np.float64)


def snp_pcadapt(pack, U_row, ind_row=None, ind_col=None,
                device=None) -> MHTest:
    """Reference snp_pcadapt (R/pcadapt.R:3-79), GC-corrected."""
    sub = pack if ind_col is None else pack.subset(ind_col=np.asarray(ind_col))
    U = np.atleast_2d(np.asarray(U_row, dtype=np.float64))
    if U.shape[0] != (sub.n if ind_row is None else len(ind_row)):
        U = U.T
    K = U.shape[1]
    t = mult_lin_reg(sub, U, ind_row=ind_row, device=device)
    if K == 1:
        ts = t[:, 0]
        dist = (ts - np.nanmedian(ts)) ** 2
    else:
        dist = dist_ogk(np.nan_to_num(t))
    gwas = MHTest(score=dist, predict=chisq_log10_predictor(K))
    return snp_gc(gwas)


bed_pcadapt = snp_pcadapt
