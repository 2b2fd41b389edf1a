"""Does LDpred2-auto converge on chip_smoke.py's one-chromosome AR(1)
cohort, with and without population structure and PC covariates?

Runs on the CPU, at a size the twins can take, with both packages:

    python ldpred2_probe.py [--n 8000] [--m 8000] [--chains 8]

For each cohort (three populations at Fst 0.02, or one) and GWAS
(covariates: the 10 PCs of snp_randomSVD on the int8m operator, or none),
it runs LDpred2-auto (60 burn-in + 40 sweeps, shrink_corr 0.95, no sign
jumps) three ways: the JAX package's unblocked sampler, the port's
unblocked sampler and the port's blocked one on the true LD blocks. It
prints the finite chains and their h2 estimates. chip_smoke.py's slice 5
uses the configuration where all three converge.
"""

import argparse
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--m", type=int, default=8000)
    ap.add_argument("--chains", type=int, default=8)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bigsnpr_tpu_torch as bp
    import chip_smoke as cs
    from bigsnpr_tpu.ops.corr import SparseLD as JaxSparseLD
    from bigsnpr_tpu.pgs import ldpred2 as jl

    bp.config.set_device("cpu")
    dev = torch.device("cpu")
    n, m = args.n, args.m
    for pops in (3, 0):
        packed, sizes, _ = cs.make_ld_cohort(torch, dev, n, m, 31, 200, 800,
                                             pops=pops)
        pack = bp.GenoPack(packed=packed.numpy(), n=n)
        perm = np.random.default_rng(32).permutation(n)
        train = np.sort(perm[:n * 3 // 4])
        sc = bp.bed_scaleBinom(pack, ind_row=train)
        op = bp.GenoOperator(pack, sc["center"], sc["scale"], ind_row=train,
                             mxu="int8m")
        svd = bp.snp_randomSVD(None, {"center": sc["center"],
                                      "scale": sc["scale"]}, op=op, k=10)
        y = bp.snp_simuPheno(pack, h2=0.4, M=m // 10, seed=1)["pheno"]
        corr = bp.snp_cor(pack, ind_row=train, size=500, thr_r2=0.01)
        for covar in (svd.u, None):
            g = bp.big_univLinReg(pack, y[train], covar=covar, ind_row=train)
            df = {"beta": g["estim"], "beta_se": g["std.err"],
                  "n_eff": np.full(m, float(len(train)))}
            h2 = float(bp.snp_ldsc2(corr, df)["h2"])
            kw = dict(h2_init=max(h2, 1e-3),
                      vec_p_init=np.geomspace(1e-4, 0.2, args.chains),
                      burn_in=60, num_iter=40, allow_jump_sign=False,
                      shrink_corr=0.95)
            runs = (("JAX unblocked", lambda: jl.snp_ldpred2_auto(
                        JaxSparseLD(upper=corr.upper), df, **kw)),
                    ("port unblocked", lambda: bp.snp_ldpred2_auto(
                        corr, df, **kw)),
                    ("port blocked", lambda: bp.snp_ldpred2_auto(
                        corr, df, blocks=sizes, **kw)))
            for name, run in runs:
                t = time.perf_counter()
                h2s = np.array([r["h2_est"] for r in run()])
                ok = np.isfinite(h2s)
                print(f"populations {pops or 1}, covariates "
                      f"{'10 PCs' if covar is not None else 'none'}, {name}: "
                      f"{ok.sum()} of {len(h2s)} chains finite, h2 "
                      f"{np.round(h2s[ok], 3).tolist()} (LDSC {h2:.3f}; "
                      f"{time.perf_counter() - t:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
