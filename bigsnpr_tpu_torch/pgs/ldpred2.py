"""LDpred2: infinitesimal, grid and auto models (port of
`bigsnpr_tpu/pgs/ldpred2.py`).

Reference: R/LDpred2.R + src/ldpred2*.cpp. The scale/unscale contract:
scale = sqrt(n_eff * beta_se^2 + beta^2); the samplers operate on
beta_hat = beta / scale and results are multiplied back
(reference R/LDpred2.R:34-41, 88-90, 139, 224-226, 257).

The grid and auto models run on the blocked samplers (`blocks=`) or, by
default, on the unblocked ones (`blocks=None`: one band over every
variant, the reference's own sampler); either way every chain or grid
cell runs in one chain-batched sweep through the CUDA sweep kernel.
`return_sampling_betas` always takes the unblocked sampler, as in the JAX
package. LDpred2-auto splits the blocked sampler over several devices
(`parallel.mesh.shard_devices`) with `shard_chains` (its chains) or
`shard_blocks` (its LD blocks); each shard runs the sweep kernel on its
own part.
"""

from __future__ import annotations

import hashlib
import warnings

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.ops.ldscores import ld_scores_sfbm
from bigsnpr_tpu_torch.parallel.mesh import shard_devices
from bigsnpr_tpu_torch.pgs import gibbs
from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb
from bigsnpr_tpu_torch.pgs.band import one_block_bands
from bigsnpr_tpu_torch.pgs.gibbs import chain_generators
from bigsnpr_tpu_torch.utils.assertions import check_args
from bigsnpr_tpu_torch.utils.profiling import count, span, to_host


def _dtype(dtype):
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError("dtype must be float32 or float64")
    return dtype


def _df_beta_arrays(df_beta):
    beta = np.asarray(df_beta["beta"], dtype=np.float64)
    beta_se = np.asarray(df_beta["beta_se"], dtype=np.float64)
    n_eff = np.asarray(df_beta["n_eff"], dtype=np.float64)
    assert np.all(beta_se > 0), "beta_se must be positive"
    scale = np.sqrt(n_eff * beta_se**2 + beta**2)
    return beta / scale, n_eff, scale


@check_args()
def snp_ldpred2_inf(corr, df_beta, h2: float) -> np.ndarray:
    """Infinitesimal model: solve (R + m/(h2 N) I) x = beta_hat on the
    sparse LD (reference snp_ldpred2_inf, R/LDpred2.R:27-42); an exact
    sparse solve on the host."""
    assert h2 > 0
    beta_hat, N, scale = _df_beta_arrays(df_beta)
    m = corr.shape[0]
    assert len(beta_hat) == m, "corr and df_beta dims must match"
    A = corr.sym().tocsc().astype(np.float64) + sp.diags(m / (h2 * N))
    return spla.spsolve(A, beta_hat) * scale


def _blocked_setup(corr, blocks, ind_corr, dt, device):
    """The bucketed block bands and their copy on the device."""
    bb = _block_bands(corr, blocks, ind_corr, dt)
    return bb, bb.device_put(device, dtype=dt)


def _block_bands(corr, blocks, ind_corr, dt):
    """The bucketed block bands. blocks: a BlockBands (used as it is), an
    array of block sizes, or "auto" — exact independence cuts from the LD
    structure, oversized blocks split by snp_ldsplit."""
    if isinstance(blocks, gb.BlockBands):
        bb = blocks
    else:
        if isinstance(blocks, str):
            assert blocks == "auto", f"unknown blocks mode {blocks!r}"
            blocks = gb.auto_blocks(corr, ind_corr=ind_corr)
        bb = gb.build_block_bands(corr, np.asarray(blocks, dtype=np.int64),
                                  ind_corr=ind_corr, dtype=dt)
    if bb.dropped_r2_frac > 0.05:
        warnings.warn(
            f"block-diagonal LD approximation drops "
            f"{100 * bb.dropped_r2_frac:.1f}% of the off-diagonal r^2 mass "
            f"at block boundaries — consider ldsplit-derived blocks "
            f"(blocks='auto') or wider blocks.", RuntimeWarning,
            stacklevel=3)
    return bb


def _unblocked_setup(corr, ind_corr, dt, device, n_beta):
    """The unblocked samplers' one band over every variant of the subset,
    on the device."""
    sb = one_block_bands(corr, ind_corr, dt).device_put(device, dtype=dt)
    assert sb.m == n_beta, "corr (or ind_corr) and df_beta dims must match"
    return sb


@check_args()
@span("ldpred2.grid")
def snp_ldpred2_grid(corr, df_beta, grid_param, burn_in: int = 50,
                     num_iter: int = 100,
                     return_sampling_betas: bool = False, ind_corr=None,
                     seed: int = 1, blocks=None, dtype="float32",
                     device=None) -> np.ndarray:
    """Grid model (reference snp_ldpred2_grid, R/LDpred2.R:73-140).
    grid_param: mapping with p, h2, sparse columns. Returns an (m, n_grid)
    matrix of effects on the allele scale (NaN columns where a cell
    diverged), or with return_sampling_betas (one grid point) the (m,
    num_iter) sampling betas of the unblocked sampler, whatever `blocks`.
    blocks: None (the unblocked sampler), a BlockBands, block sizes or
    "auto"."""
    beta_hat, N, scale = _df_beta_arrays(df_beta)
    dt = _dtype(dtype)
    dev = config.resolve_device(device)
    p_grid = np.atleast_1d(np.asarray(grid_param["p"], dtype=np.float64))
    h2_grid = np.atleast_1d(np.asarray(grid_param["h2"], dtype=np.float64))
    sp_grid = np.atleast_1d(np.asarray(grid_param["sparse"], dtype=bool))
    assert np.all(h2_grid > 0)
    with span("ldpred2.setup"):
        gens = chain_generators(seed, len(p_grid), dev)
        if return_sampling_betas:
            assert len(p_grid) == 1, "only one set of parameters allowed"
        if return_sampling_betas or blocks is None:
            sb = _unblocked_setup(corr, ind_corr, dt, dev, len(beta_hat))
        else:
            bb, sb = _blocked_setup(corr, blocks, ind_corr, dt, dev)
            assert bb.m == len(beta_hat)
    if return_sampling_betas:
        out = gibbs.gibbs_one_sampling(sb, beta_hat, N, h2_grid[0],
                                       p_grid[0], bool(sp_grid[0]), gens[0],
                                       burn_in, num_iter)
    elif blocks is None:
        out = gibbs.gibbs_one(sb, beta_hat, N, h2_grid, p_grid, sp_grid,
                              gens, burn_in, num_iter)
    else:
        out = gb.gibbs_multi_blocked(sb, beta_hat, N, h2_grid, p_grid,
                                     sp_grid, gens, burn_in, num_iter)
    with span("ldpred2.to_host"):
        return to_host(out.double()).T * scale[:, None]


def _mean_ld(corr, ind_corr_np):
    """Mean LD score over the subset, cached on `corr` per subset (the
    O(nnz) host pass is paid once for repeated calls)."""
    key = hashlib.md5(np.ascontiguousarray(ind_corr_np).tobytes()).hexdigest()
    cache = getattr(corr, "_mean_ld_cache", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(corr, "_mean_ld_cache", cache)
        except AttributeError:
            pass
    if key not in cache:
        cache[key] = float(np.mean(ld_scores_sfbm(corr, ind_sub=ind_corr_np)))
    return cache[key]


@check_args()
def snp_ldpred2_auto(corr, df_beta, h2_init: float, vec_p_init=0.1,
                     burn_in: int = 500, num_iter: int = 200,
                     sparse: bool = False, report_step: int | None = None,
                     allow_jump_sign: bool = True, shrink_corr: float = 1.0,
                     use_MLE: bool = True, p_bounds=(1e-5, 1.0),
                     alpha_bounds=(-1.5, 0.5), ind_corr=None, seed: int = 1,
                     blocks=None, shard_blocks: bool = False,
                     shard_chains: bool = False, dtype="float32",
                     device=None, mesh=None,
                     state_sweeps=None) -> list[dict]:
    """Auto model (reference snp_ldpred2_auto, R/LDpred2.R:203-286), all
    chains in one chain-batched sampler: unblocked (`blocks=None`, one
    band over every variant) or blocked.

    shard_chains: split the chains of the blocked sampler over the shards
    of `mesh` (a Mesh, a list of devices, or by default one shard a CUDA
    device; `parallel.mesh.shard_devices`); needs blocks= and a chain
    count that the shard count divides. Each chain draws its own stream,
    so a chain's result does not depend on the split. shard_blocks: split
    the blocked sampler's LD blocks over the shards, balanced by rows;
    after each sweep the per-chain sums over all blocks and variants are
    gathered to the first shard in global order and reduced there as the
    unsharded run reduces them. It needs blocks= too (ValueError). The
    two are mutually exclusive; both give the unsharded result.

    Returns a list (over vec_p_init) of dicts with beta_est, postp_est,
    corr_est, sample_beta, path_{p,h2,alpha}_est, {h2,p,alpha}_est,
    h2_init, p_init (and beta_est_sparse when sparse=True); the blocked
    sampler adds dropped_r2_frac.

    state_sweeps (off the R API): None, the default, returns the above
    and nothing else. A sequence, which may be empty, of sweeps (0-based
    over burn_in + num_iter) adds path_sigma2_est, the sigma2 each sweep's
    update sets, and the chains' states after those sweeps, copied as the
    run goes without a host sync (into page-locked host memory when the
    sampler runs on a card): in the sampler's dtype, on its scaled axis
    (beta / scale), a row a kept sweep in ascending order, state_beta
    (the current effects), state_sum_beta, state_sum_postp and
    state_sum_corr (the running sums behind beta_est, postp_est and
    corr_est), and state_h2 (the running h2 before its floor of 1e-3).
    Either way every other output is the same, bit for bit."""
    assert h2_init > 0
    assert not (shard_chains and blocks is None), \
        "shard_chains requires blocks= (the chain-batched sampler)"
    assert not (shard_chains and shard_blocks), \
        "shard_chains and shard_blocks are mutually exclusive"
    if shard_blocks and blocks is None:
        raise ValueError("shard_blocks requires blocks= (it splits the LD "
                         "blocks over the shards)")
    beta_hat, N, scale = _df_beta_arrays(df_beta)
    sd = 1.0 / scale
    log_var = 2.0 * np.log(sd)
    dt = _dtype(dtype)
    dev = config.resolve_device(device)
    ind_corr_np = (np.arange(corr.shape[0]) if ind_corr is None
                   else np.asarray(ind_corr))
    mean_ld = _mean_ld(corr, ind_corr_np)
    if report_step is None:
        report_step = num_iter + 1
    vec_p_init = np.atleast_1d(np.asarray(vec_p_init, dtype=np.float64))
    NC = len(vec_p_init)

    args = (beta_hat, N, log_var, vec_p_init, h2_init)
    kw = dict(shrink_corr=shrink_corr, p_bounds=p_bounds,
              alpha_bounds=np.asarray(alpha_bounds, dtype=np.float64) + 1,
              mean_ld=mean_ld, burn_in=burn_in, num_iter=num_iter,
              report_step=report_step, use_mle=use_MLE,
              no_jump_sign=not allow_jump_sign, state_sweeps=state_sweeps)
    run_grid = gibbs.gibbs_one if blocks is None else gb.gibbs_multi_blocked
    sb = None
    if blocks is None:
        bb = None
        sb = _unblocked_setup(corr, ind_corr, dt, dev, len(beta_hat))
        outs = gibbs.gibbs_auto(sb, *args, chain_generators(seed, NC, dev),
                                **kw)
    elif shard_chains or shard_blocks:
        bb = _block_bands(corr, blocks, ind_corr, dt)
        assert bb.m == len(beta_hat)
        shards = shard_devices(mesh, dev)
        dev = shards[0]
        if shard_chains:
            assert NC % len(shards) == 0, (
                f"{NC} chains must divide the {len(shards)}-shard chain "
                "mesh")
            per = NC // len(shards)
            outs = gb.gibbs_auto_shard_chains(
                [(bb.device_put(d, dtype=dt),
                  chain_generators(seed, NC, d)[i * per:(i + 1) * per])
                 for i, d in enumerate(shards)], *args, **kw)
        else:
            outs = gb.gibbs_auto_shard_blocks(
                [(s, var, blk, chain_generators(seed, NC, d))
                 for (s, var, blk), d in
                 zip(gb.shard_block_bands(bb, shards, dt), shards)],
                *args, **kw)
    else:
        bb, sb = _blocked_setup(corr, blocks, ind_corr, dt, dev)
        assert bb.m == len(beta_hat)
        outs = gb.gibbs_auto_blocked_multi(
            sb, *args, chain_generators(seed, NC, dev), **kw)
    state, state_h2 = outs.pop("state", None), outs.pop("state_h2", None)
    if state_sweeps is None:
        del outs["path_sigma2_est"]
    outs_np = {k: v.double().cpu().numpy() for k, v in outs.items()}
    count("auto.diverged", int(np.isnan(outs_np["path_p_est"][:, -1]).sum()))
    if state is not None:
        state, state_h2 = state.numpy(), state_h2.cpu().numpy()
        for i, k in enumerate(("state_beta", "state_sum_beta",
                               "state_sum_postp", "state_sum_corr")):
            outs_np[k] = state[:, :, i]
        outs_np["state_h2"] = state_h2
    results = []
    for c in range(NC):
        res = {k: v[c] for k, v in outs_np.items()}
        res["beta_est"] = res["beta_est"] / sd
        res["h2_est"] = float(np.mean(res["path_h2_est"][-num_iter:]))
        res["p_est"] = float(np.mean(res["path_p_est"][-num_iter:]))
        res["alpha_est"] = float(np.mean(res["path_alpha_est"][-num_iter:]))
        res["h2_init"] = h2_init
        res["p_init"] = float(vec_p_init[c])
        if bb is not None:
            res["dropped_r2_frac"] = bb.dropped_r2_frac
        results.append(res)
    if sparse:
        # post-hoc sparse solutions (reference R/LDpred2.R:266-279) for
        # the chains whose h2 estimate is finite, batched
        live = [c for c in range(NC) if np.isfinite(results[c]["h2_est"])]
        if live:
            if sb is None:       # sharded: the sparse runs on the first shard
                sb = bb.device_put(dev, dtype=dt)
            salted = chain_generators(seed, NC, dev, salt=(12345,))
            gens = [salted[c] for c in live]
            bg = run_grid(
                sb, beta_hat, N, [results[c]["h2_est"] for c in live],
                [results[c]["p_est"] for c in live], np.ones(len(live), bool),
                gens, 50, 100)
            bg = bg.double().cpu().numpy()
            for i, c in enumerate(live):
                results[c]["beta_est_sparse"] = bg[i] / sd
    return results


def ldpred2_auto_chain_qc(multi_auto, quantile: float = 0.95):
    """Vignette chain-QC rule (reference vignettes/LDpred2.Rmd:421-431):
    keep chains whose corr_est range exceeds 0.95 * the `quantile`-th
    quantile of ranges. Returns (keep_mask, beta_auto = mean over kept)."""
    ranges = np.array([
        (np.nanmax(r["corr_est"]) - np.nanmin(r["corr_est"]))
        if np.isfinite(r["corr_est"]).any() else np.nan
        for r in multi_auto
    ])
    thr = 0.95 * np.nanquantile(ranges, quantile)
    keep = ranges > thr
    if keep.any():
        beta_auto = np.mean([multi_auto[i]["beta_est"]
                             for i in np.nonzero(keep)[0]], axis=0)
    else:
        beta_auto = np.full_like(multi_auto[0]["beta_est"], np.nan)
    return keep, beta_auto

