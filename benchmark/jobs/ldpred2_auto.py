"""Job kind `ldpred2_auto`: LDpred2-auto as the LDpred2 vignette runs it,
on the resident LD: `snp_ldpred2_auto` with the LDSC h2 as h2_init, the
traffic mix's chains (vec_p_init = seq_log(from, to, n)), burn-in, kept
sweeps, shrink_corr, jump rule and MLE, the blocks from `auto_blocks` and
a new seed a job; then the vignette's chain QC (`ldpred2_auto_chain_qc`),
the mean of the kept chains, and its scores on the target samples
(`snp_prodVec`, K2).

The job keeps the chains' states after the sweeps `benchref.ldpred2_auto.
kept_sweeps` names for the cell file's `segment`, with the sigma2 path
(`state_sweeps`), so that `check` can follow every sweep: see
`benchref.ldpred2_auto.judge`. The scores are held against the
reference's G beta, beta the mean of the program's beta_est over the
chains its QC keeps (`prs_gap`), whose verdicts `judge` holds against
the reference's own QC (`qc_mismatch`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import ldpred2_setup as common
from benchlib.harness import job_seed
from benchref import ldpred2 as ref_grid
from benchref import ldpred2_auto as ref

PATHS = ("path_p_est", "path_h2_est", "path_alpha_est", "path_sigma2_est")
STATES = ("state_beta", "state_sum_beta", "state_sum_postp",
          "state_sum_corr", "state_h2")
OUTPUTS = ("beta_est", "postp_est", "corr_est")


def p_init(tr):
    s = tr["p_init"]
    return np.exp(np.linspace(np.log(s["from"]), np.log(s["to"]), s["n"]))


def setup(ctx):
    """The LDpred2 set-up, then a warm-up job of 4 + 4 sweeps that keeps
    as many states as a job (so that a job's host buffer for them is one
    the warm-up freed)."""
    st = common.setup(ctx)
    st["p_init"] = p_init(ctx.traffic)
    T = int(ctx.traffic["burn_in"]) + int(ctx.traffic["num_iter"])
    n_kept = len(ref.kept_sweeps(T, int(ctx.cellf["segment"])))
    run(st, ctx, -1, job_seed(ctx.seed, -1), burn_in=n_kept // 2,
        num_iter=n_kept - n_kept // 2, kept=list(range(n_kept)))
    return st


def run(st, ctx, i, seed, burn_in=None, num_iter=None, kept=None):
    bp, tr = st["bp"], ctx.traffic
    burn_in = tr["burn_in"] if burn_in is None else burn_in
    num_iter = tr["num_iter"] if num_iter is None else num_iter
    if kept is None:
        kept = ref.kept_sweeps(burn_in + num_iter, int(ctx.cellf["segment"]))
    t0 = time.perf_counter()
    with record_function("bench.ldpred2_auto"):
        multi = bp.snp_ldpred2_auto(
            st["corr"], st["df_beta"], h2_init=st["h2"],
            vec_p_init=st["p_init"], burn_in=burn_in, num_iter=num_iter,
            allow_jump_sign=tr["allow_jump_sign"],
            shrink_corr=tr["shrink_corr"], use_MLE=tr["use_MLE"],
            p_bounds=tr["p_bounds"], alpha_bounds=tr["alpha_bounds"],
            blocks=st["bb"], seed=seed, device=ctx.dev, state_sweeps=kept)
    ctx.span("ldpred2", time.perf_counter() - t0)
    with record_function("bench.chain_qc"):
        keep, beta_auto = bp.ldpred2_auto_chain_qc(multi)
    with record_function("bench.prs"):
        pred = bp.snp_prodVec(st["target"], np.nan_to_num(beta_auto, nan=0.0),
                              device=ctx.dev)
    return {"multi": multi, "kept": kept, "keep": keep, "pred": np.asarray(
        pred)}


counters = common.counters
release = common.release


def shapes(st):
    """The auto sweep reads beta_hat, n_eff and log_var a variant, and a
    chain and variant the current effect; it writes the new one and the
    three the averages consume (postp, C3 postp, the LD product), and the
    causal flag."""
    return {"sweep": {"band_entries": st["ld_entries"], "m": st["m"],
                      "chains": len(st["p_init"]), "variant_words": 3,
                      "chain_words": 5, "chain_bytes": 1}}


def program_arrays(res):
    """The job's result as `ref.judge` reads it: (NC, ...) arrays."""
    multi = res["multi"]
    out = {k: np.stack([c[k] for c in multi])
           for k in PATHS + STATES + OUTPUTS}
    out["p_init"] = np.array([c["p_init"] for c in multi])
    out["h2_init"] = float(multi[0]["h2_init"])
    out["kept"], out["keep"] = list(res["kept"]), np.asarray(res["keep"])
    return out


def settings(tr):
    return dict(burn_in=int(tr["burn_in"]), num_iter=int(tr["num_iter"]),
                shrink=float(tr["shrink_corr"]),
                no_jump=not tr["allow_jump_sign"],
                p_bounds=tr["p_bounds"], alpha_bounds=tr["alpha_bounds"])


def beta_auto(prog):
    """The mean of beta_est over the chains the QC keeps, 0 without any,
    NaN as 0 (as the job scores it)."""
    keep = np.asarray(prog["keep"])
    if not keep.any():
        return np.zeros(prog["beta_est"].shape[1])
    return np.nan_to_num(prog["beta_est"][keep].mean(0), nan=0.0)


def control_run(R, prog, seed, kw, st):
    """The control in the program's place: the reference's whole run in
    bfloat16 with its own QC; and the scores of the program's mean of
    its kept chains on bf16 operands."""
    c = ref.run_auto(R, prog["p_init"], prog["h2_init"], seed,
                     kw["burn_in"], kw["num_iter"], kw["shrink"],
                     kw["no_jump"], kw["p_bounds"], kw["alpha_bounds"],
                     prog["kept"], dtype=torch.bfloat16)
    c["keep"] = ref.chain_qc(c["corr_est"])
    pred = ref_grid.scores(st["packed"], st["n"], st["test"],
                           beta_auto(prog), control=True)
    return c, pred


def check(st, ctx, sample, control=False):
    if not ctx.traffic["use_MLE"]:
        raise ValueError("the check follows the MLE's update: use_MLE true")
    R = common.derive_reference(st, ctx)
    kw, cf = settings(ctx.traffic), ctx.cellf
    out = dict.fromkeys(cf["limits"], 0.0)
    for i, seed, res in sample:
        prog = program_arrays(res)
        pred = res["pred"]
        pred_ref = ref_grid.scores(st["packed"], st["n"], st["test"],
                                   beta_auto(prog))
        if control:
            prog, pred = control_run(R, prog, seed, kw, st)
        vals = ref.judge(R, prog, seed, lane_tol=float(cf["lane_tol"]),
                         log=ctx.log, **kw)
        vals["prs_gap"] = ref_grid.rel_gap(np.reshape(pred, -1),
                                           np.reshape(pred_ref, -1))
        ctx.log(f"job {i} (seed {seed}, {int(np.isnan(prog['beta_est']).any(1).sum())} "
                f"diverged, {int(np.sum(prog['keep']))} kept by the QC, "
                f"program h2_init {prog['h2_init']:.4f}, LDSC h2 "
                f"{R['h2']:.4f}): {vals}")
        for k, v in vals.items():
            out[k] = max(out[k], v) if np.isfinite(v) else np.inf
    return out


def control(st, ctx, sample):
    """The control's readings: the reference's whole LDpred2-auto in
    bfloat16 put in the program's place, judged as the program is."""
    return check(st, ctx, sample, control=True)
