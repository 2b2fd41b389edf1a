"""Phenotype simulation (reference snp_simuPheno, R/simu-pheno.R:36-92).

Liabilities calibrated so the genetic part has *exactly* variance h2 and
the total *exactly* variance 1 (in-sample), with the reference's
cross-covariance correction for the environmental part. Draws the same
numpy `default_rng(seed)` stream as the JAX package, so one seed gives
the same causal set and effects in both.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as scipy_stats

from bigsnpr_tpu_torch.ops.matvec import snp_prodVec
from bigsnpr_tpu_torch.ops.stats import snp_colstats
from bigsnpr_tpu_torch.utils.assertions import check_args


@check_args()
def snp_simuPheno(pack, h2: float, M: int, K: float | None = None,
                  alpha: float = -1.0, ind_row=None, ind_possible=None,
                  prob=None, effects_dist: str = "gaussian",
                  seed: int | None = None, device=None) -> dict:
    rng = np.random.default_rng(seed)
    m_all = pack.m
    if ind_possible is None:
        ind_possible = np.arange(m_all)
    ind_possible = np.asarray(ind_possible)
    if prob is not None:
        prob = np.asarray(prob, dtype=np.float64)
        prob = prob / prob.sum()
    ind = rng.choice(len(ind_possible), size=M, replace=False, p=prob)
    causal_set = np.sort(ind_possible[ind])

    sub = (pack if ind_row is None
           else pack.subset(ind_row=np.asarray(ind_row), device=device))
    st = snp_colstats(sub, device=device)
    var = st["denoX"] / np.maximum(st["nona"] - 1, 1)
    sd = np.sqrt(var[causal_set])

    if effects_dist == "gaussian":
        effects = rng.normal(0.0, sd**alpha)
    elif effects_dist == "laplace":
        effects = rng.laplace(0.0, sd**alpha)
    else:
        raise ValueError("effects_dist must be 'gaussian' or 'laplace'")

    # genetic liability on raw allele counts (center=0, scale=1)
    u = np.zeros(sub.m)
    u[causal_set] = effects
    gen_liab = np.asarray(snp_prodVec(sub, u, device=device), dtype=np.float64)

    coeff1 = np.sqrt(h2) / np.std(gen_liab, ddof=1)
    gen_liab = gen_liab * coeff1
    gen_liab -= gen_liab.mean()

    env = rng.normal(0.0, np.sqrt(1 - h2), size=len(gen_liab))
    var_env = np.var(env, ddof=1)
    cov_env = np.cov(gen_liab, env, ddof=1)[0, 1]
    coeff2 = (np.sqrt(cov_env**2 + (1 - h2) * var_env) - cov_env) / var_env
    full_liab = gen_liab + (env * coeff2 - (env * coeff2).mean())

    if K is None:
        pheno = full_liab
    else:
        pheno = (full_liab > scipy_stats.norm.isf(K)).astype(np.int64)

    return {
        "pheno": pheno,
        "set": causal_set,
        "effects": effects * coeff1 * sd,
        "allelic_effects": effects * coeff1,
    }
