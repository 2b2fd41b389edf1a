"""The LDpred2 cells' inputs and the program's set-up, for the job kind
`ldpred2_grid` and any later LDpred2 job kind on the same LD.

Inputs: the one-chromosome cohort (`cohorts.ld_cohort`, on the device)
and its GWAS / target split are one, drawn from the configuration's
`cohort_seed`, as an LD reference panel is one; the run's seed draws the
trait (its causal variants and effects) and the jobs' seeds. So every
seed gives the sampler the same LD, blocks and bands: with cohorts drawn
afresh, the bands' bucket layout, and with it the grid's job time, moved
by up to ~20% from seed to seed. The program's
set-up, as the LDpred2 vignette runs it: the marginal GWAS on the GWAS
samples (`big_univLinReg`), the LD (`snp_cor`), the LDSC heritability
(`snp_ldsc2`), the blocks (`auto_blocks`) and their bands on the device
(`build_block_bands`), and the target samples' pack (`GenoPack.subset`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import cohorts

def setup(ctx):
    import bigsnpr_tpu_torch as bp
    from bigsnpr_tpu_torch.ops import geno_kernels as gk
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    cfg, dev = ctx.cfg, ctx.dev
    n, m = int(cfg["n_samples"]), int(cfg["n_variants"])
    t0 = time.perf_counter()
    cohort = int(cfg["cohort_seed"])
    packed, sizes = cohorts.ld_cohort(
        torch, dev, n, m, cohort, cfg["block_min"], cfg["block_max"],
        cfg["rho"], cfg["maf_range"], cfg["na_variant_share"],
        cfg["na_rate"])
    y = cohorts.phenotype(torch, packed, n, ctx.seed, cfg["h2"],
                          cfg["n_causal"])
    perm = np.random.default_rng([cohort, 14]).permutation(n)
    n_gwas = int(cfg["n_gwas"])
    train, test = np.sort(perm[:n_gwas]), np.sort(perm[n_gwas:])
    pack = bp.GenoPack(packed=packed.cpu().numpy(), n=n)
    t1 = time.perf_counter()
    gwas = bp.big_univLinReg(pack, y[train], ind_row=train, device=dev)
    df_beta = {"beta": gwas["estim"], "beta_se": gwas["std.err"],
               "n_eff": np.full(m, float(n_gwas))}
    corr = bp.snp_cor(pack, ind_row=train, size=cfg["ld_window"],
                      thr_r2=cfg["ld_thr_r2"], finalize="device",
                      device=dev)
    h2 = float(bp.snp_ldsc2(corr, df_beta)["h2"])
    bb = bp.build_block_bands(corr, bp.auto_blocks(corr))
    bb.device_put(dev)
    target = pack.subset(ind_row=test, device=dev)
    ctx.sync()
    ctx.log(f"set-up: cohort {t1 - t0:.3f} s, GWAS to bands and target "
            f"{time.perf_counter() - t1:.3f} s; {len(sizes)} generated LD "
            f"blocks, {len(bb.buckets)} buckets of auto_blocks, LD nnz "
            f"{corr.upper.nnz}, LDSC h2 {h2:.4f}")
    return {"bp": bp, "gk": gk, "gsk": gsk, "packed": packed, "n": n,
            "m": m, "y": y, "train": train, "test": test, "pack": pack,
            "df_beta": df_beta, "corr": corr, "h2": h2, "bb": bb,
            "target": target, "ld_entries": int(corr.upper.nnz)}


def counters(st):
    return {**st["gk"].launches, **st["gsk"].launches}


def release(st):
    import gc

    for k in ("pack", "corr", "bb", "target", "df_beta"):
        st.pop(k, None)
    gc.collect()


def derive_reference(st, ctx):
    """The reference's own set-up from the benchmark's bytes."""
    from benchref import ldpred2 as ref

    return ref.derive(st["packed"], st["n"], st["train"],
                      st["y"][st["train"]], int(ctx.cfg["ld_window"]),
                      float(ctx.cfg["ld_thr_r2"]))
