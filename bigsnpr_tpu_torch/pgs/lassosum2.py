"""lassosum2: elastic-net-style coordinate descent on sparse LD (port of
`bigsnpr_tpu/pgs/lassosum2.py`).

Reference: snp_lassosum2 (R/lassosum2.R:25-81) + CD kernel
(src/lassosum2.cpp:21-70). Deterministic given (corr, df_beta, grid).
Every grid point runs at once through the sweep kernel's lassosum mode:
on the blocked bands (`blocks=`, `pgs/gibbs_blocked.py::
lassosum_cd_blocked`) or, by default, on one band over every variant
(`blocks=None`, the JAX package's unblocked `lassosum_cd`, `pgs/gibbs.py`;
the same kernel on a card).
"""

from __future__ import annotations

import numpy as np

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.pgs import gibbs
from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb
from bigsnpr_tpu_torch.pgs.ldpred2 import (_blocked_setup, _df_beta_arrays,
                                           _dtype, _unblocked_setup)


def seq_log(a, b, n):
    """Log-spaced sequence (reference seq_log, R/SCT.R:167-171)."""
    return np.exp(np.linspace(np.log(a), np.log(b), n))


def snp_lassosum2(corr, df_beta, delta=(0.001, 0.01, 0.1, 1),
                  nlambda: int = 30, lambda_min_ratio: float = 0.01,
                  dfmax: float = 200e3, maxiter: int = 1000,
                  tol: float = 1e-5, ind_corr=None, blocks=None,
                  dtype="float32", device=None):
    """Returns (beta_grid (m, n_grid), grid_param), grid_param a dict of
    numpy columns lambda / delta / num_iter / sparsity in the reference's
    expand.grid order (lambda fastest within each delta). NaN columns
    where a grid point diverged. dtype: "float32" or "float64". blocks:
    None (one band over every variant), a BlockBands, block sizes or
    "auto", as for snp_ldpred2_grid."""
    beta_hat, N, scale = _df_beta_arrays(df_beta)
    dt = _dtype(dtype)
    dev = config.resolve_device(device)
    if blocks is None:
        sb, run = _unblocked_setup(corr, ind_corr, dt, dev,
                                   len(beta_hat)), gibbs.lassosum_cd
    else:
        bb, sb = _blocked_setup(corr, blocks, ind_corr, dt, dev)
        assert bb.m == len(beta_hat)
        run = gb.lassosum_cd_blocked

    pf = np.sqrt(np.max(N) / N)
    lambda0 = np.max(np.abs(beta_hat / pf))
    seq_lam = seq_log(lambda0, lambda_min_ratio * lambda0, nlambda + 1)[1:]
    del_grid, lam_grid = np.meshgrid(np.asarray(delta, dtype=np.float64),
                                     seq_lam, indexing="ij")
    lam_grid = lam_grid.ravel()
    del_grid = del_grid.ravel()
    betas, iters = run(sb, beta_hat, pf, lam_grid, del_grid, dfmax, tol,
                       maxiter)
    betas = betas.cpu().numpy()
    beta_grid = betas.astype(np.float64).T * scale[:, None]
    grid_param = {
        "lambda": lam_grid,
        "delta": del_grid,
        "num_iter": iters.cpu().numpy(),
        "sparsity": np.mean(betas == 0, axis=1),
    }
    return beta_grid, grid_param
