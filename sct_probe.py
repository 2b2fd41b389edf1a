#!/usr/bin/env python3
"""Time SCT's stacking (snp_grid_stacking) against the number of samples
it runs on, on one GPU.

    python3 sct_probe.py [--sizes N ...] [--budget S] [chip_smoke.py flags]

Makes chip_smoke.py's slice-4 cohort (20,000 x 100,000, 15,000 training
and 5,000 test samples, from --seed) and runs phase [13]'s SCT path:
snp_randomSVD -> snp_simuPheno -> big_univLinReg under pallas_mxu
"split2" -> gwas_pvalues -> snp_grid_clumping -> snp_grid_PRS on every
training sample, each stage timed. Then snp_grid_stacking on the scores of
random subsets of the training samples, one size after another in
increasing order (the subset of a size is the one chip_smoke.py draws for
--n-stack of that size), each timed on the host clock with r(SCT
prediction, y_test). A size is skipped when the last size's time, scaled
by the square of the size ratio, exceeds what is left of --budget seconds.
Prints the card's name and power limit first. Needs a CUDA device, unless
--rehearse-cpu runs it through the twins at a small --n4 / --m4.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs

    ap = cs.arg_parser()
    ap.description = __doc__.splitlines()[0]
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[1_000, 2_000, 3_000, 5_000])
    ap.add_argument("--budget", type=float, default=1_000.0,
                    help="seconds of stacking in all")
    args = ap.parse_args(argv)

    import torch

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("sct_probe: no CUDA device", file=sys.stderr)
        return 2
    import bigsnpr_tpu_torch as bp

    dev = torch.device("cpu" if args.rehearse_cpu else "cuda")
    bp.config.set_device(str(dev))
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)

    def stage(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        print(f"  {name:26s} {dt:9.3f} s", flush=True)
        return out, dt

    pack, chrs, pos, train, test, _ = cs.make_slice4(bp, torch, dev, args)
    with bp.config.options(pallas_mxu="split2"):
        svd, _ = stage("snp_randomSVD", lambda: bp.snp_randomSVD(
            pack, k=10, ind_row=train))
        sim, _ = stage("snp_simuPheno", lambda: bp.snp_simuPheno(
            pack, h2=0.4, M=min(1000, pack.m // 10), seed=args.seed))
        y = sim["pheno"]
        gwas, _ = stage("big_univLinReg", lambda: bp.big_univLinReg(
            pack, y[train], covar=svd.u, ind_row=train))
    lpS = -bp.gwas_pvalues(gwas, log10=True)
    (all_keep, _), _ = stage("snp_grid_clumping", lambda: bp.snp_grid_clumping(
        pack, chrs, pos, lpS, ind_row=train))
    multi, _ = stage(f"snp_grid_PRS ({len(train)} samples)",
                     lambda: bp.snp_grid_PRS(
                         pack, all_keep, gwas["estim"], lpS,
                         n_thr_lpS=args.n_thr, ind_row=train))
    test_pack = pack.subset(ind_row=test, device=dev)
    y_test = y[test]
    left, last = args.budget, None
    for size in sorted(set(min(s, len(train)) for s in args.sizes)):
        if last is not None and last[1] * (size / last[0]) ** 2 > left:
            print(f"  stacking on {size} samples: skipped ({left:.0f} s of "
                  f"the budget left)", flush=True)
            continue
        args.n_stack = size
        stack = cs.stack_rows(len(train), args)
        final, dt = stage(f"snp_grid_stacking ({size})",
                          lambda: bp.snp_grid_stacking(
                              dataclasses.replace(
                                  multi, scores=multi.scores[stack]),
                              y[train[stack]]))
        left -= dt
        last = (size, dt)
        pred = bp.snp_prodVec(test_pack, final["beta.G"]) + final["intercept"]
        mod = final["mod"]
        print(f"    alpha {mod.alpha}, {int((mod.beta != 0).sum())} of "
              f"{len(mod.beta)} columns non-zero; r(SCT prediction, y_test) "
              f"{float(np.corrcoef(pred, y_test)[0, 1]):.4f} on {len(test)} "
              f"test samples", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
