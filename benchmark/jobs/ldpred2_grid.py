"""Job kind `ldpred2_grid`: the LDpred2 vignette's grid on the resident
LD: `snp_ldpred2_grid` over every (p, h2, sparse) model of the traffic
mix, h2 as multiples of the LDSC estimate, with its burn-in and kept
sweeps, the blocks from `auto_blocks` and a new seed a job; then the
target samples' scores of every model in one product (`snp_prodVec`,
K2), diverged models scored as zeros.

Checked by `benchref.ldpred2` (see `check`): a sample of the models,
drawn from the run's seed, replayed over every sweep with the program's
draws, and every score.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from benchlib import ldpred2_setup as common
from benchlib.harness import job_seed
from benchref import ldpred2 as ref


def grid(tr, h2):
    """The models in the vignette's expand.grid order: p fastest, then
    h2, then sparse."""
    s = tr["p"]
    p = np.exp(np.linspace(np.log(s["from"]), np.log(s["to"]), s["n"]))
    h2s = h2 * np.asarray(tr["h2_factors"], np.float64)
    sp = np.asarray(tr["sparse"], bool)
    P, H, S = np.meshgrid(p, h2s, sp, indexing="ij")
    return {"p": P.ravel("F"), "h2": H.ravel("F"), "sparse": S.ravel("F")}


def setup(ctx):
    st = common.setup(ctx)
    st["grid"] = grid(ctx.traffic, st["h2"])
    run(st, ctx, -1, job_seed(ctx.seed, -1), burn_in=1, num_iter=1)
    return st


def run(st, ctx, i, seed, burn_in=None, num_iter=None):
    bp, tr = st["bp"], ctx.traffic
    burn_in = tr["burn_in"] if burn_in is None else burn_in
    num_iter = tr["num_iter"] if num_iter is None else num_iter
    t0 = time.perf_counter()
    with record_function("bench.ldpred2_grid"):
        beta = bp.snp_ldpred2_grid(st["corr"], st["df_beta"], st["grid"],
                                   burn_in=burn_in, num_iter=num_iter,
                                   blocks=st["bb"], seed=seed,
                                   device=ctx.dev)
    ctx.span("ldpred2", time.perf_counter() - t0)
    with record_function("bench.prs"):
        pred = bp.snp_prodVec(st["target"], np.nan_to_num(beta, nan=0.0),
                              device=ctx.dev)
    return {"beta": beta, "pred": np.asarray(pred)}


counters = common.counters
release = common.release


def shapes(st):
    return {"sweep": {"band_entries": st["ld_entries"], "m": st["m"],
                      "chains": len(st["grid"]["p"]), "variant_words": 2,
                      "chain_words": 3, "chain_bytes": 0}}


def lane_mismatch(beta, beta_ref, sizes, tol):
    """Over the models, the largest share of LD blocks in which a model's
    effects differ from the reference's by more than `tol` of the
    reference's norm there; 1 for a model that diverged on one side only,
    0 for one that diverged on both. A block parts from the reference once
    a draw lies within rounding of its threshold, so the sound program
    reads a few blocks in its worst model."""
    edges = np.r_[0, np.cumsum(sizes)]
    worst = 0.0
    for b, r in zip(beta, beta_ref):
        fb, fr = np.isfinite(b).all(), np.isfinite(r).all()
        if fb != fr:
            return 1.0
        if fb:
            bad = sum(np.linalg.norm(b[s:e] - r[s:e]) > tol * np.linalg.norm(
                r[s:e]) for s, e in zip(edges[:-1], edges[1:]))
            worst = max(worst, bad / len(sizes))
    return float(worst)


def check(st, ctx, sample, control=False):
    R = common.derive_reference(st, ctx)
    tr, cf = ctx.traffic, ctx.cellf
    g = grid(tr, R["h2"])
    n_cells = len(g["p"])
    rng = np.random.default_rng([ctx.seed, 15])
    out = {"lane_mismatch": 0.0, "prs_gap": 0.0}
    for i, seed, res in sample:
        cells = np.sort(rng.choice(n_cells, int(cf["replayed_models"]),
                                   replace=False))
        br = ref.replay_grid(R, g["h2"], g["p"], g["sparse"], cells, n_cells,
                             seed, tr["burn_in"], tr["num_iter"])
        B = np.nan_to_num(res["beta"], nan=0.0)
        pred_ref = ref.scores(st["packed"], st["n"], st["test"], B)
        if control:
            got = ref.replay_grid(R, g["h2"], g["p"], g["sparse"], cells,
                                  n_cells, seed, tr["burn_in"],
                                  tr["num_iter"], control=True)
            got_pred = ref.scores(st["packed"], st["n"], st["test"], B,
                                  control=True)
        else:
            got, got_pred = res["beta"][:, cells].T, res["pred"]
        vals = {"lane_mismatch": lane_mismatch(got, br, R["sizes"],
                                               float(cf["lane_tol"])),
                "prs_gap": ref.rel_gap(got_pred, pred_ref)}
        ctx.log(f"job {i} (seed {seed}, models {cells.tolist()}, "
                f"{int(np.isnan(res['beta']).any(0).sum())} diverged, LDSC "
                f"h2 {R['h2']:.4f}): {vals}")
        for k, v in vals.items():
            out[k] = max(out[k], v) if np.isfinite(v) else np.inf
    return out


def control(st, ctx, sample):
    """The control's readings: the reference put in the program's place
    in bfloat16 (the sampled models' sweeps, the scores)."""
    return check(st, ctx, sample, control=True)
