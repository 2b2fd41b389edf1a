"""Job kind `randomsvd`: one PCA of the resident cohort,
`bed_randomSVD(pack, k, seed=<job>)`, the binomial scaling included.

Set-up makes the cohort on the device from the seed (`cohorts.pca_cohort`,
gathered into host memory as a .bed read would leave it), and runs one
whole job as the warm-up: it uploads the pack, builds the operator and
loads K1 / K2. Checked by `benchref.pca.judge` on the benchmark's own
bytes, over the PCs of population structure: one fewer than the
cohort's populations. The later PCs lie in the noise bulk, where
neighbouring singular values all but tie and no PCA's vectors converge.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchlib import cohorts
from benchlib.harness import job_seed
from benchref import pca as ref


def setup(ctx):
    import bigsnpr_tpu_torch as bp
    from bigsnpr_tpu_torch.ops import geno_kernels as gk

    cfg, tr = ctx.cfg, ctx.traffic
    n, m = int(cfg["n_samples"]), int(cfg["n_variants"])
    t0 = time.perf_counter()
    counts, fst = cohorts.populations(cfg["groups"], cfg["uk_regions"], n)
    host, _ = cohorts.pca_cohort(
        torch, ctx.dev, n, m, ctx.seed, counts, fst, cfg["maf_range"],
        cfg["na_variant_share"], cfg["na_rate"])
    k = int(tr["k"])
    st = {"bp": bp, "gk": gk, "host": host, "n": n, "m": m, "k": k,
          "judged": min(k, len(counts) - 1),
          "oversample": int(tr["oversample"]),
          "tol": float(tr["tol"]), "pack": bp.GenoPack(packed=host, n=n)}
    t1 = time.perf_counter()
    run(st, ctx, -1, job_seed(ctx.seed, -1))
    ctx.log(f"set-up: cohort {t1 - t0:.3f} s, warm-up job (upload, "
            f"operator, kernels) {time.perf_counter() - t1:.3f} s")
    return st


def run(st, ctx, i, seed):
    svd = st["bp"].bed_randomSVD(st["pack"], k=st["k"], tol=st["tol"],
                                 oversample=st["oversample"], seed=seed,
                                 device=ctx.dev)
    return {"d": svd.d, "u": svd.u, "v": svd.v, "niter": svd.niter}


def counters(st):
    return dict(st["gk"].launches)


def shapes(st):
    return {"geno": {"n": st["n"], "m": st["m"],
                     "l": st["k"] + st["oversample"]}}


def release(st):
    st.pop("pack", None)
    gc.collect()


def check(st, ctx, sample, control=False):
    packed = torch.as_tensor(st["host"], device=ctx.dev)
    J, out = st["judged"], {}
    for i, seed, res in sample:
        if control:
            d, u, v, depth = ref.control_svd(packed, st["n"], st["k"],
                                             st["oversample"], st["tol"],
                                             seed=seed)
        else:
            d, u, v, depth = res["d"], res["u"], res["v"], res["niter"]
        vals = ref.judge(packed, st["n"], d[:J], u[:, :J], v[:, :J])
        ctx.log(f"job {i} (seed {seed}, {depth} depths, d "
                f"{np.round(np.asarray(d), 2).tolist()}): {vals}")
        for name, val in vals.items():
            out[name] = (max(out.get(name, 0.0), val) if np.isfinite(val)
                         else np.inf)
    return out


def control(st, ctx, sample):
    """The control's readings: the reference's block-Krylov SVD put in
    the program's place, its product operands rounded to TF32."""
    return check(st, ctx, sample, control=True)
