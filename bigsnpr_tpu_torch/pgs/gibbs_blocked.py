"""Block-parallel LDpred2 over ragged LD blocks (port of
`bigsnpr_tpu/pgs/gibbs_blocked.py`).

The reference's Gibbs chains are strictly sequential over all m variants
(src/ldpred2-auto.cpp:109-159). When the LD matrix is block-diagonal
(snp_ldsplit blocks, the reference's recommended practice), variants in
different blocks never interact through dotprods, so the chain factorizes
exactly: the rows of each block in order, all blocks and all chains at
once, with the global hyper-parameter updates (p, h2, MLE) reduced across
blocks after each sweep. Cross-block LD entries are dropped; `BlockBands`
reports their r^2 mass.

Blocks are bucketed by (padded size, padded width) exactly as in the JAX
package, so the host buckets of both packages are identical. On the
device (`BlockBands.device_put`) every bucket goes into one flat arena
(`ops.gibbs_kernels.SweepBands`), and one launch of the sweep kernel
covers every block of every bucket for every chain. The whole sweep loop,
hyper-parameter updates included, stays on the device: nothing in it
waits on the host.

LDpred2-auto also runs over several devices: `gibbs_auto_shard_chains`
splits its chains (each shard runs its own chains' sweeps), and
`gibbs_auto_shard_blocks` its blocks (`split_blocks`: whole blocks,
balanced by rows; each shard sweeps its blocks for every chain, and the
per-chain step runs on the first shard from the shards' sums gathered in
global order). Both give the unsharded result, bit for bit: a shard's
per-chain sums over variants or blocks are reduced as the whole run's
chain count (`pgs.gibbs.row_sums`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from bigsnpr_tpu_torch.ops import gibbs_kernels
from bigsnpr_tpu_torch.pgs.gibbs import (MIN_H2, MleGraph, _beta_draw,
                                         _poisson1, draw, poisson1_cdf,
                                         row_sums)
from bigsnpr_tpu_torch.utils.profiling import span


def _round_up(x: int, candidates=(8, 16, 32, 64, 128)) -> int:
    """Round up to a small set of bucket sizes: powers of two up to 128,
    then multiples of 128."""
    for c in candidates:
        if x <= c:
            return c
    return -(-x // 128) * 128


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


class BlockBands:
    """Bucketed per-block banded LD.

    buckets : list of (bands, gidx) with bands (Bk, mbk, 2Wk+1) —
        band[b, j, Wk+d] = R[j, j+d] within block b — and gidx (Bk, mbk)
        int32, the global variant index of each slot, -1 at padding.
    m : total number of variants across blocks.
    dropped_r2 / kept_r2 : sum of squared off-diagonal LD entries dropped
        at block boundaries / kept inside blocks.
    dropped_r2_frac : dropped_r2 / (dropped_r2 + kept_r2), 0.0 when there
        is no off-diagonal mass.
    """

    def __init__(self, buckets, m, dropped_r2=0.0, kept_r2=0.0):
        self.buckets = buckets
        self.m = m
        self.dropped_r2 = float(dropped_r2)
        self.kept_r2 = float(kept_r2)
        self._dev_cache = {}

    @property
    def dropped_r2_frac(self):
        tot = self.dropped_r2 + self.kept_r2
        return self.dropped_r2 / tot if tot > 0 else 0.0

    @property
    def nbytes(self):
        return sum(b.nbytes for b, _ in self.buckets)

    def device_put(self, device=None, dtype=None) -> gibbs_kernels.SweepBands:
        """The bands on `device` as the sweep kernel's operand, in their
        natural (rows, 2W + 1) layout; cached per (device, dtype)."""
        from bigsnpr_tpu_torch import config

        dev = config.resolve_device(device)
        if dtype is None:
            dtype = self.buckets[0][0].dtype if self.buckets else np.float32
        tdt = _TORCH_DTYPES[np.dtype(dtype)]
        key = (str(dev), tdt)
        if key not in self._dev_cache:
            self._dev_cache[key] = gibbs_kernels.SweepBands(
                self.buckets, self.m, dev, tdt)
        return self._dev_cache[key]


def block_layout(block_sizes):
    """(slot_of_global (m,), global_of_slot (B, mb), valid (B, mb)) of a
    uniform layout (kept for the JAX package's surface and its tests)."""
    sizes = np.asarray(block_sizes, dtype=np.int64)
    B, mb = len(sizes), int(sizes.max())
    m = int(sizes.sum())
    slot = np.empty(m, dtype=np.int64)
    gos = np.full((B, mb), -1, dtype=np.int64)
    start = 0
    for b, sz in enumerate(sizes):
        slot[start:start + sz] = b * mb + np.arange(sz)
        gos[b, :sz] = start + np.arange(sz)
        start += sz
    return slot, gos, gos >= 0


def build_block_bands(corr, block_sizes, ind_corr=None, dtype=np.float32):
    """Per-block banded LD bucketed by (padded size, padded width), built
    straight from the upper COO triplets (the JAX package's "coo"
    engine): block ids from the CSC column order, one segmented max for
    the per-block widths, and one flat scatter into a single arena that
    holds every bucket (cross-block entries go to a dump slot, so there
    is no filtering pass). Returns a BlockBands."""
    sizes = np.asarray(block_sizes, dtype=np.int64)
    m2 = corr.shape[0]
    u = corr.upper.tocoo()          # CSC -> COO: column-sorted, i <= j
    lo = np.asarray(u.row)
    hi = np.asarray(u.col)
    x = np.asarray(u.data)
    del u
    if lo.size and (lo > hi).any():  # tolerate non-upper storage
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)

    if ind_corr is not None:
        ind_corr = np.asarray(ind_corr)
        assert sizes.sum() == len(ind_corr)
        if len(ind_corr) != m2 or (np.diff(ind_corr) != 1).any():
            posmap = np.full(m2, -1, dtype=lo.dtype)
            posmap[ind_corr] = np.arange(len(ind_corr), dtype=lo.dtype)
            lo = posmap[lo]
            hi = posmap[hi]
            keepm = (lo >= 0) & (hi >= 0)
            lo, hi, x = lo[keepm], hi[keepm], x[keepm]
            # a reordering subset can flip an upper entry to lower
            lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    else:
        assert sizes.sum() == m2

    nb = len(sizes)
    starts = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    if lo.size and (np.diff(hi) < 0).any():  # a reordering subset: sort
        order = np.argsort(hi, kind="stable")
        lo, hi, x = lo[order], hi[order], x[order]
    # hi ascending (CSC order) -> block ids by a boundary search over nb
    # values, expanded with one repeat
    bounds_e = np.searchsorted(hi, starts)
    bid = np.repeat(np.arange(nb, dtype=np.int32), np.diff(bounds_e))
    inblk = lo >= starts[bid]       # same block iff lo past hi's start

    # off-diagonal r^2 bookkeeping over the SYMMETRIC matrix (off-diag
    # mass counted twice), matching the scipy path's semantics
    w2 = np.square(x)
    diagm = hi == lo
    total2 = 2.0 * float(w2.sum())
    diag_sq = float(w2[diagm].sum())
    kept2 = 2.0 * float(w2[inblk].sum())
    kept_diag = float(w2[inblk & diagm].sum())   # == diag_sq normally
    total_sq = total2 - diag_sq
    kept_sq = kept2 - kept_diag
    dropped_r2 = max(total_sq - kept_sq, 0.0)
    kept_r2 = max(kept_sq - kept_diag, 0.0)
    del w2, diagm

    off = hi - lo                    # index dtype (int32/int64 per scipy)

    # per-block bandwidth: segmented max over the contiguous per-block
    # entry ranges; dropped entries contribute 0
    Wb_arr = np.zeros(nb, dtype=np.int64)
    if off.size:
        offm = np.where(inblk, off, 0)
        cnt = np.diff(bounds_e)
        segmax = np.maximum.reduceat(
            offm, np.minimum(bounds_e[:-1], off.size - 1))
        Wb_arr[cnt > 0] = segmax[cnt > 0]
        del offm

    groups = {}
    for b in range(nb):
        key = (_round_up(int(sizes[b])), _round_up(2 * int(Wb_arr[b]) + 1))
        groups.setdefault(key, []).append(b)
    keys_sorted = sorted(groups.items())

    # one arena for all buckets + a trailing dump slot; per-block
    # gather tables stay cache-resident (nb entries)
    blk_base = np.empty(nb, dtype=np.int64)   # flat index of band[b, 0, Wk]
    blk_wk = np.empty(nb, dtype=np.int64)     # row stride (stored width)
    arena_off = []
    total = 0
    for (mbk, wk_key), blks in keys_sorted:
        Wk = (wk_key - 1) // 2
        wk = 2 * Wk + 1             # stored width is odd (center + W each way)
        arena_off.append(total)
        for b_loc, b in enumerate(blks):
            blk_base[b] = total + (b_loc * mbk) * wk + Wk
            blk_wk[b] = wk
        total += len(blks) * mbk * wk
    flat = np.zeros(total + 1, dtype=dtype)

    if off.size:
        x32 = x.astype(dtype, copy=False)
        # band[b, j, Wk + d] = R[j, j+d]: entry (lo, hi) lands at row hi
        # offset -off and mirrored at row lo offset +off (diagonal
        # entries write the same slot twice — harmless)
        stride = blk_wk[bid]
        base = blk_base[bid]
        base += (hi - starts[bid]) * stride
        dump = np.int64(total)
        np.subtract(base, off, where=inblk, out=base)
        base[~inblk] = dump
        flat[base] = x32
        base += np.multiply(2 * off, inblk)  # mirror; dump slot unmoved...
        base += (lo.astype(np.int64) - hi) * stride  # row hi -> row lo
        base[~inblk] = dump
        flat[base] = x32
    flat[total] = 0.0

    buckets = []
    for k, ((mbk, wk_key), blks) in enumerate(keys_sorted):
        Wk = (wk_key - 1) // 2
        wk = 2 * Wk + 1
        Bk = len(blks)
        bands = flat[arena_off[k]:arena_off[k] + Bk * mbk * wk] \
            .reshape(Bk, mbk, wk)
        gidx = np.full((Bk, mbk), -1, dtype=np.int32)
        for b_loc, b in enumerate(blks):
            sz = int(sizes[b])
            gidx[b_loc, :sz] = starts[b] + np.arange(sz)
        buckets.append((bands, gidx))
    return BlockBands(buckets, int(sizes.sum()),
                      dropped_r2=dropped_r2, kept_r2=kept_r2)


def auto_blocks(corr, ind_corr=None, max_block: int = 4096,
                thr_r2: float = 0.02, min_size: int = 32):
    """LD-block sizes for the blocked samplers.

    1. Exact cuts: positions where no kept LD entry crosses — free and
       lossless.
    2. Exact blocks longer than max_block are split with snp_ldsplit
       (dropping the small cross-block r^2, the reference's recommended
       practice for making LD block-diagonal before LDpred2-auto).
    Returns an int array of block sizes summing to len(ind_corr)."""
    from bigsnpr_tpu_torch.ops.splitld import snp_ldsplit

    m2 = corr.shape[0]
    identity = ind_corr is None or (
        len(ind_corr) == m2
        and np.array_equal(np.asarray(ind_corr), np.arange(m2)))
    ind_corr = np.arange(m2) if ind_corr is None else np.asarray(ind_corr)
    sub = corr if identity else corr.subset(ind_corr)
    m = len(ind_corr)
    # a cut after position t is exact when no entry (i <= t < j) exists:
    # the smallest row of every column right of t lies past t
    up = sub.upper.tocsc()
    lo_row = np.arange(m)
    nz = np.diff(up.indptr) > 0
    if up.nnz:
        colmin = np.minimum.reduceat(up.indices, up.indptr[:-1][nz])
        lo_row[nz] = np.minimum(colmin, lo_row[nz])
    suffix_min = np.minimum.accumulate(lo_row[::-1])[::-1]
    cut = np.r_[suffix_min[1:] > np.arange(m - 1), True]
    cuts = np.nonzero(cut)[0] + 1
    sizes = np.diff(np.r_[0, cuts])

    out = []
    start = 0
    for sz in sizes:
        if sz <= max_block:
            out.append(int(sz))
        else:
            blk = sub.subset(np.arange(start, start + sz))
            res = err = None
            try:
                res = snp_ldsplit(
                    blk, thr_r2=thr_r2, min_size=min(min_size, sz),
                    max_size=max_block,
                    max_K=max(2, -(-sz // min(min_size, sz))),
                    max_cost=np.inf, max_r2=1.0)
            except Exception as e:  # noqa: BLE001 — surfaced below
                err = e
            if res is not None:
                best = int(np.argmin(res["cost"]))
                out.extend(int(s) for s in res["all_size"][best])
            else:
                warnings.warn(
                    f"snp_ldsplit failed on a {sz}-variant LD block "
                    f"({type(err).__name__ if err else 'no result'}: {err}); "
                    f"falling back to fixed {max_block}-slabs that may cut "
                    f"through LD. Check dropped_r2_frac on the returned "
                    f"BlockBands.", RuntimeWarning, stacklevel=2)
                nb = -(-sz // max_block)
                slab = -(-sz // nb)
                rem = sz
                while rem > 0:
                    out.append(int(min(slab, rem)))
                    rem -= slab
        start += sz
    out = np.asarray(out, dtype=np.int64)
    assert out.sum() == m
    return out


# ---------------------------------------------------------------------------
# the bucketed sweep and the samplers
# ---------------------------------------------------------------------------

def sweeps_bucketed_mc(sb, dp, curr_beta, consts, u, z, inv_odd_p, p,
                       sparse_vec, shrink_corr, no_jump_sign,
                       per_block=False):
    """One full Gibbs sweep over every bucket for NC chains (the JAX
    package's `_sweeps_bucketed_mc`): curr_beta, u, z (NC, m); consts =
    (bh (m,), C2, C4, s1 each (NC, m)); inv_odd_p, p (NC,); sparse_vec
    bool (NC,). dp (NC, sb.dp_len) is updated in place. Returns nb (NC, m)
    and aux = (gap, causal, h2_inc, postp, beta_inc, dps), with gap and
    h2_inc (NC,), or (NC, nblk) by block with per_block."""
    bh, C2, C4, s1 = consts
    nb, causal, postp, binc, dps, h2_inc, gap = gibbs_kernels.sweep(
        sb, dp, curr_beta, bh, C2, C4, s1, u, z, inv_odd_p, p, sparse_vec,
        shrink_corr, no_jump_sign, per_block)
    return nb, (gap, causal, h2_inc, postp, binc, dps)


def _as(sb, x, dtype=None):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=sb.dtype if dtype is None else dtype,
                           device=sb.device)


def _grid_consts(sb, beta_hat, n_vec, h2_vec, p_vec):
    """The fixed per-sweep inputs of NC LDpred2-grid cells: (bh, C2, C4,
    s1) with C1 = h2 / (m p) n_vec, inv_odd_p, p and the divergence
    threshold gap0 = 2 sum(bh^2)."""
    bh, nv = _as(sb, beta_hat), _as(sb, n_vec)
    h2, p = _as(sb, h2_vec), _as(sb, p_vec)
    h2_per_var = h2 / (sb.m * p)
    C1 = h2_per_var[:, None] * nv[None, :]
    C2 = 1.0 / (1.0 + 1.0 / C1)
    C4 = C2 / nv[None, :]
    return (bh, C2, C4, torch.sqrt(1 + C1)), (1 - p) / p, p, \
        2.0 * torch.sum(bh**2)


def gibbs_multi_blocked(sb, beta_hat, n_vec, h2_vec, p_vec, sparse_vec, gens,
                        burn_in, num_iter):
    """LDpred2-grid over NC cells at once (the reference's process grid,
    R/LDpred2.R:100-114, in one chain-batched sweep): h2_vec, p_vec (NC,),
    sparse_vec (NC,) bool, gens one generator per cell. Returns (NC, m)
    average betas on the scaled axis, NaN rows where a cell diverged.
    Spans: `ldpred2.setup`, and per sweep `gibbs.sweep` around
    `gibbs.draw` and `gibbs.kernel`."""
    with span("ldpred2.setup"):
        consts, inv_odd_p, p, gap0 = _grid_consts(sb, beta_hat, n_vec,
                                                  h2_vec, p_vec)
        spv = _as(sb, sparse_vec, torch.bool)
        NC, m = p.shape[0], sb.m
        dp = sb.dp0(NC)
        curr = torch.zeros((NC, m), dtype=sb.dtype, device=sb.device)
        avg = torch.zeros_like(curr)
        diverged = torch.zeros(NC, dtype=torch.bool, device=sb.device)
    for k in range(burn_in + num_iter):
        with span("gibbs.sweep"):
            with span("gibbs.draw"):
                u, z = draw(gens, m, m, sb.dtype, sb.device)
            with span("gibbs.kernel"):
                curr, aux = sweeps_bucketed_mc(sb, dp, curr, consts, u, z,
                                               inv_odd_p, p, spv, 1.0, False)
            gap, beta_inc = aux[0], aux[4]
            if k >= burn_in:
                avg += torch.where(~diverged[:, None], beta_inc, 0.0)
            diverged = diverged | (gap > gap0)
    return torch.where(diverged[:, None], torch.nan, avg / num_iter)


def gibbs_sampling_blocked(sb, beta_hat, n_vec, h2, p, sparse, gen, burn_in,
                           num_iter):
    """One LDpred2-grid cell that keeps its samples
    (ldpred2_gibbs_one_sampling, src/ldpred2-sampling.cpp:9-59): the new
    betas of each of the num_iter sweeps after the burn-in, (num_iter, m)
    on the scaled axis, all NaN if the chain diverged."""
    consts, inv_odd_p, pv, gap0 = _grid_consts(sb, beta_hat, n_vec, [h2],
                                               [p])
    spv = _as(sb, [sparse], torch.bool)
    m = sb.m
    dp = sb.dp0(1)
    curr = torch.zeros((1, m), dtype=sb.dtype, device=sb.device)
    samples = torch.empty((num_iter, m), dtype=sb.dtype, device=sb.device)
    diverged = torch.zeros(1, dtype=torch.bool, device=sb.device)
    for k in range(burn_in + num_iter):
        u, z = draw([gen], m, m, sb.dtype, sb.device)
        curr, aux = sweeps_bucketed_mc(sb, dp, curr, consts, u, z,
                                       inv_odd_p, pv, spv, 1.0, False)
        if k >= burn_in:
            samples[k - burn_in] = curr[0]
        diverged = diverged | (aux[0] > gap0)
    return torch.where(diverged, torch.nan, samples)


def gibbs_one_blocked(sb, beta_hat, n_vec, h2, p, sparse, gen, burn_in,
                      num_iter):
    """One LDpred2-grid cell (ldpred2_gibbs_one, src/ldpred2.cpp:8-69) on
    the blocked bands: `gibbs_multi_blocked` with one chain. Returns the
    (m,) average betas, NaN on divergence."""
    return gibbs_multi_blocked(sb, beta_hat, n_vec, [h2], [p], [sparse],
                               [gen], burn_in, num_iter)[0]


class _AutoPart:
    """One shard of an LDpred2-auto run: its bands `sb`, the generators
    of the run's chains on its device, and its per-variant state. Under
    `shard_blocks` sb holds some of the blocks, its slots numbered over
    its own variants, whose global ids are `var`, and `blk` gives each of
    its blocks' place among all the blocks; else both are None."""

    def __init__(self, sb, var, blk, gens, beta_hat, n_vec, log_var, NC,
                 num_reports, num_kept):
        dt, dev = sb.dtype, sb.device
        self.sb, self.var, self.blk, self.gens = sb, var, blk, gens
        take = (lambda x: x) if var is None else (lambda x: x[var])
        self.bh = take(_as(sb, beta_hat))
        self.nv = take(_as(sb, n_vec))
        self.lv = take(_as(sb, log_var))
        self.dp = sb.dp0(NC)
        self.curr = torch.zeros((NC, sb.m), dtype=dt, device=dev)
        self.avg_postp, self.avg_beta, self.avg_bhat = (
            torch.zeros_like(self.curr) for _ in range(3))
        self.samples = torch.zeros((NC, max(num_reports, 1), sb.m),
                                   dtype=dt, device=dev)
        self.no_sparse = torch.zeros(NC, dtype=torch.bool, device=dev)
        self.cdf = poisson1_cdf(dt, dev)
        # the kept states on the host, page-locked where the sweep runs on
        # a card so that their copies do not wait: (kept sweeps, 4, NC,
        # its variants), the current effects and the sums behind beta_est,
        # postp_est and corr_est
        self.state = (torch.empty((num_kept, 4, NC, sb.m), dtype=dt,
                                  pin_memory=dev.type == "cuda")
                      if num_kept else None)

    def cols(self, X, j0):
        """Columns j0 + (this shard's variants) of the (NC, .) draws."""
        if self.var is None:
            return X[:, j0:j0 + self.sb.m].contiguous()
        return X[:, j0 + self.var]


class _AutoRun:
    """The LDpred2-auto chains of one group (every chain of an unsharded
    or `shard_blocks` run, one shard's chains under `shard_chains`) over
    the shards of its blocks (`parts`: one, or several under
    `shard_blocks`). The per-chain step runs once, on the first part's
    device. Its sums over all blocks or variants (the divergence gap, the
    h2 increment, the alpha-MLE sums) take the parts' values gathered
    there in global block or variant order and reduce them as one part's
    would be reduced, so a split of the blocks leaves every bit of the
    result as it was."""

    def __init__(self, parts, m, p_inits, h2_init, num_iter_tot, kw):
        self.parts, self.m, self.kw = parts, m, kw
        sb = parts[0].sb
        dt, dev = sb.dtype, sb.device
        self.dt, self.dev = dt, dev
        p_inits = torch.as_tensor(p_inits, dtype=dt, device=dev)
        NC = p_inits.shape[0]
        self.p = torch.clamp(p_inits, *kw["p_bounds"])
        h2_0 = max(float(h2_init), MIN_H2)
        self.cur_h2 = torch.zeros(NC, dtype=dt, device=dev)
        self.par_alpha = torch.zeros(NC, dtype=dt, device=dev)
        self.par_sigma2 = h2_0 / (m * self.p)
        self.paths = torch.full((NC, 4, num_iter_tot), torch.nan, dtype=dt,
                                device=dev)
        self.state_h2 = torch.zeros((NC, len(kw["keep"])), dtype=dt,
                                    device=dev)
        self.diverged = torch.zeros(NC, dtype=torch.bool, device=dev)
        self.mle = MleGraph(kw["alpha_bounds"], kw["chains"])
        self.split = len(parts) > 1
        bh = _as(sb, kw["beta_hat"])
        self.gap0 = 2.0 * torch.sum(bh ** 2)
        if self.split:
            self.lv = _as(sb, kw["log_var"])
            self.nblk = sum(part.sb.nblk for part in parts)
            for part in parts:
                part.blk_d, part.var_d = part.blk.to(dev), part.var.to(dev)

    @span("auto.sweep")
    def sweep(self, k):
        """Every part's sweep of iteration k, with its draws (`gibbs.draw`
        and `gibbs.kernel` spans a part)."""
        kw, m, dt = self.kw, self.m, self.dt
        use_mle = kw["use_mle"]
        for i, part in enumerate(self.parts):
            d = part.sb.device
            p, ps, pa, div = (x.to(d) for x in (self.p, self.par_sigma2,
                                                self.par_alpha,
                                                self.diverged))
            inv_odd_p = (1 - p) / p
            C1 = ps[:, None] * part.nv[None, :]
            if use_mle:
                C1 = torch.exp(pa[:, None] * part.lv[None, :]) * C1
            C2 = 1.0 / (1.0 + 1.0 / C1)
            C4 = C2 / part.nv[None, :]
            s1 = torch.sqrt(1 + C1)
            with span("gibbs.draw"):
                U, Z = draw(part.gens, m + 16 + (m if use_mle else 0),
                            m + 2, dt, d)
            with span("gibbs.kernel"):
                nb, aux = sweeps_bucketed_mc(
                    part.sb, part.dp, part.curr, (part.bh, C2, C4, s1),
                    part.cols(U, 0), part.cols(Z, 0), inv_odd_p, p,
                    part.no_sparse, kw["shrink_corr"], kw["no_jump_sign"],
                    per_block=True)
            part.gap, part.causal, part.h2_inc, postp_inc, beta_inc, dps = aux
            if k >= kw["burn_in"]:
                pm = ~div[:, None]
                part.avg_postp += torch.where(pm, postp_inc, 0.0)
                part.avg_beta += torch.where(pm, beta_inc, 0.0)
                part.avg_bhat += torch.where(pm, dps, 0.0)
            if use_mle:
                part.wts = _poisson1(part.cols(U, m + 16),
                                     part.cdf) * part.causal
            part.nb = nb
            if i == 0:
                self.uz = (U[:, m:m + 16], Z[:, m:m + 2])

    def _whole(self, name, by_block=False):
        """The parts' `name`, (NC, their blocks) or (NC, their variants),
        gathered on `dev` in global block or variant order."""
        first = getattr(self.parts[0], name)
        out = torch.empty((first.shape[0], self.nblk if by_block else
                           self.m), dtype=first.dtype, device=self.dev)
        for part in self.parts:
            out[:, part.blk_d if by_block else part.var_d] = getattr(
                part, name).to(self.dev)
        return out

    @span("auto.update")
    def update(self, k):
        """The per-chain step of iteration k: spans `auto.sums` (the sums
        over blocks and variants), `auto.p` (the draw of p), `auto.mle`
        (alpha and sigma2) and, at a kept sweep, `auto.keep` (the state's
        copies); h2 and the paths in the step's own time."""
        kw, m = self.kw, self.m
        pb0, pb1 = kw["p_bounds"]
        part = self.parts[0]
        with span("auto.sums"):
            if self.split:
                gap = row_sums(self._whole("gap", by_block=True))
                h2_inc = row_sums(self._whole("h2_inc", by_block=True))
                causal, nb = self._whole("causal"), self._whole("nb")
                lv = self.lv
                wts = self._whole("wts") if kw["use_mle"] else None
            else:
                rows = kw["chains"]
                gap = row_sums(part.gap, rows)
                h2_inc = row_sums(part.h2_inc, rows)
                causal, nb, lv = part.causal, part.nb, part.lv
                wts = getattr(part, "wts", None)
            ok = ~self.diverged
            div2 = self.diverged | (gap > self.gap0)
            nb_causal = causal.sum(1).to(self.dt)
        with span("auto.p"):
            U, Z = self.uz
            mean_ld = kw["mean_ld"]
            p2 = _beta_draw(Z, U[:, :8], U[:, 8:16],
                            1 + nb_causal / mean_ld,
                            1 + (m - nb_causal) / mean_ld)
            p2 = torch.where(ok, torch.clamp(p2, pb0, pb1), self.p)
        h2_est2 = torch.where(ok, self.cur_h2 + h2_inc, self.cur_h2)
        h2 = torch.clamp(h2_est2, min=MIN_H2)
        if kw["use_mle"]:
            with span("auto.mle"):
                pa, ps = self.mle(self.par_sigma2, wts, lv, nb * nb)
                pa = torch.where(ok, pa, self.par_alpha)
                ps = torch.where(ok, ps, self.par_sigma2)
        else:
            pa = self.par_alpha
            ps = torch.where(ok, h2 / (m * p2), self.par_sigma2)

        vals = torch.stack([p2, h2, pa - 1.0, ps], dim=1)
        self.paths[:, :, k] = torch.where(div2[:, None], self.paths[:, :, k],
                                          vals)
        burn_in, step, reps = (kw["burn_in"], kw["report_step"],
                               kw["num_reports"])
        if reps > 0 and k >= burn_in and (k - burn_in + 1) % step == 0:
            rep = min(max((k - burn_in + 1) // step - 1, 0), reps - 1)
            for part in self.parts:
                dv = div2.to(part.sb.device)[:, None]
                row = torch.where(part.causal & ~dv, part.nb, 0.0)
                part.samples[:, rep] = torch.where(dv, part.samples[:, rep],
                                                   row)
        for part in self.parts:
            part.curr = part.nb
        self.p, self.cur_h2, self.par_alpha, self.par_sigma2 = (p2, h2_est2,
                                                                pa, ps)
        self.diverged = div2
        slot = kw["keep"].get(k)
        if slot is not None:
            with span("auto.keep"):
                for part in self.parts:
                    for i, x in enumerate((part.curr, part.avg_beta,
                                           part.avg_postp, part.avg_bhat)):
                        part.state[slot, i].copy_(x, non_blocking=True)
                self.state_h2[:, slot] = h2_est2

    def result(self, num_iter):
        """The dict of (NC, ...) tensors on the first part's device, the
        per-variant ones in global variant order."""
        def whole(name):
            if not self.split:
                return getattr(self.parts[0], name)
            first = getattr(self.parts[0], name)
            out = torch.empty((*first.shape[:-1], self.m), dtype=self.dt,
                              device=self.dev)
            for part in self.parts:
                out[..., part.var_d] = getattr(part, name).to(self.dev)
            return out

        nan = torch.where(self.diverged[:, None], torch.nan,
                          0.0).to(self.dt)
        out = {
            "beta_est": whole("avg_beta") / num_iter + nan,
            "postp_est": whole("avg_postp") / num_iter + nan,
            "corr_est": whole("avg_bhat") / num_iter + nan,
            "sample_beta": whole("samples"),
            "path_p_est": self.paths[:, 0], "path_h2_est": self.paths[:, 1],
            "path_alpha_est": self.paths[:, 2],
            "path_sigma2_est": self.paths[:, 3],
        }
        if self.kw["keep"]:
            out["state"], out["state_h2"] = self._states(), self.state_h2
        return out

    def _states(self):
        """The kept states, (NC, kept, 4, m) on the host in global
        variant order, once their copies have landed."""
        for part in self.parts:
            if part.sb.device.type == "cuda":
                torch.cuda.current_stream(part.sb.device).synchronize()
        st = self.parts[0].state
        if self.split:
            st = torch.empty((*st.shape[:-1], self.m), dtype=st.dtype)
            for part in self.parts:
                st[..., part.var.cpu()] = part.state
        return st.permute(2, 0, 1, 3)


def kept_sweeps(state_sweeps, num_iter_tot: int) -> dict:
    """{sweep: slot} of the sweeps whose states a run keeps, in
    ascending order; ValueError for a sweep outside [0, num_iter_tot) or
    named twice."""
    if state_sweeps is None:
        return {}
    ks = [int(k) for k in np.atleast_1d(np.asarray(state_sweeps))]
    if len(set(ks)) != len(ks) or any(not 0 <= k < num_iter_tot
                                      for k in ks):
        raise ValueError(f"state_sweeps must be distinct sweeps in [0, "
                         f"{num_iter_tot}), got {ks}")
    return {k: i for i, k in enumerate(sorted(ks))}


def _auto_runs(groups, beta_hat, n_vec, log_var, p_inits, h2_init,
               shrink_corr, p_bounds, alpha_bounds, mean_ld, burn_in,
               num_iter, report_step, use_mle, no_jump_sign,
               state_sweeps=None):
    """Run the chain groups side by side, sweep by sweep, so that groups
    on different cards overlap: groups is a list of (chain slice of
    p_inits, [(sb, var, blk, gens)] the group's parts). Returns each
    group's `_AutoRun.result`: with `state_sweeps`, also its states after
    those sweeps, `state` (NC, kept, 4, m: the current effects and the
    sums behind beta_est, postp_est and corr_est) and `state_h2` (NC,
    kept: the running h2 before its floor). The states are copied as the
    run goes, without waiting: into page-locked host memory on a card."""
    num_iter_tot = burn_in + num_iter
    keep = kept_sweeps(state_sweeps, num_iter_tot)
    if report_step is None:
        report_step = num_iter + 1
    num_reports = num_iter // report_step if report_step <= num_iter else 0
    p_inits = np.asarray(p_inits.cpu() if torch.is_tensor(p_inits)
                         else p_inits, dtype=np.float64)
    m = len(beta_hat)
    kw = dict(shrink_corr=shrink_corr,
              p_bounds=(float(p_bounds[0]), float(p_bounds[1])),
              alpha_bounds=alpha_bounds, mean_ld=mean_ld, burn_in=burn_in,
              report_step=report_step, num_reports=num_reports,
              use_mle=use_mle, no_jump_sign=no_jump_sign,
              beta_hat=beta_hat, log_var=log_var, chains=len(p_inits),
              keep=keep)
    runs = []
    for chains, shards in groups:
        p0 = p_inits[chains]
        parts = [_AutoPart(sb, var, blk, gens, beta_hat, n_vec, log_var,
                           len(p0), num_reports, len(keep))
                 for sb, var, blk, gens in shards]
        runs.append(_AutoRun(parts, m, p0, h2_init, num_iter_tot, kw))
    for k in range(num_iter_tot):
        for run in runs:
            run.sweep(k)
        for run in runs:
            run.update(k)
    return [run.result(num_iter) for run in runs]


def gibbs_auto_blocked_multi(sb, beta_hat, n_vec, log_var, p_inits, h2_init,
                             gens, shrink_corr, p_bounds, alpha_bounds,
                             mean_ld, burn_in, num_iter, report_step=None,
                             use_mle=True, no_jump_sign=False,
                             state_sweeps=None):
    """LDpred2-auto for NC chains at once (ldpred2_gibbs_auto,
    src/ldpred2-auto.cpp:56-202; the reference's 30-process chain grid,
    R/LDpred2.R:233-236, in one chain-batched sweep). p_inits (NC,), gens
    one generator per chain, alpha_bounds on the alpha+1 scale. Returns a
    dict of (NC, ...) tensors (`_auto_runs`)."""
    return _auto_runs(
        [(slice(None), [(sb, None, None, gens)])], beta_hat, n_vec, log_var,
        p_inits, h2_init, shrink_corr, p_bounds, alpha_bounds, mean_ld,
        burn_in, num_iter, report_step, use_mle, no_jump_sign,
        state_sweeps)[0]


def gibbs_auto_shard_chains(shards, beta_hat, n_vec, log_var, p_inits,
                            h2_init, shrink_corr, p_bounds, alpha_bounds,
                            mean_ld, burn_in, num_iter, report_step=None,
                            use_mle=True, no_jump_sign=False,
                            state_sweeps=None):
    """`gibbs_auto_blocked_multi` with the chains split over shards:
    shards is a list of (sb, gens), sb the bands on the shard's device and
    gens the generators of its chains (chain c's stream does not depend
    on the chains beside it, `pgs.gibbs.chain_generators`), the shards'
    chains in chain order. Each shard sweeps its own chains; the results
    are concatenated in chain order on the first shard's device."""
    per = len(p_inits) // len(shards)
    groups = [(slice(i * per, (i + 1) * per), [(sb, None, None, g)])
              for i, (sb, g) in enumerate(shards)]
    outs = _auto_runs(groups, beta_hat, n_vec, log_var, p_inits, h2_init,
                      shrink_corr, p_bounds, alpha_bounds, mean_ld, burn_in,
                      num_iter, report_step, use_mle, no_jump_sign,
                      state_sweeps)
    dev = shards[0][0].device
    return {k: torch.cat([o[k] if k == "state" else o[k].to(dev)
                          for o in outs]) for k in outs[0]}


def gibbs_auto_shard_blocks(shards, beta_hat, n_vec, log_var, p_inits,
                            h2_init, shrink_corr, p_bounds, alpha_bounds,
                            mean_ld, burn_in, num_iter, report_step=None,
                            use_mle=True, no_jump_sign=False,
                            state_sweeps=None):
    """`gibbs_auto_blocked_multi` with the LD blocks split over shards:
    shards is a list of (sb, var, blk, gens) (`shard_block_bands`: a
    shard's blocks, the global ids of their variants, their places among
    all blocks) with gens every chain's generators on the shard's device.
    Each shard sweeps its own blocks for every chain. After each sweep the
    per-chain quantities summed over all blocks or variants (the
    divergence gap, the h2 increment, the causal count, the alpha-MLE
    sums) are reduced on the first shard from the shards' values in
    global order, as the unsharded sampler reduces them, and the
    per-chain step runs there once: every shard steps with the same
    values, and the result is the unsharded one."""
    return _auto_runs(
        [(slice(None), list(shards))], beta_hat, n_vec, log_var, p_inits,
        h2_init, shrink_corr, p_bounds, alpha_bounds, mean_ld, burn_in,
        num_iter, report_step, use_mle, no_jump_sign, state_sweeps)[0]


def split_blocks(bb: BlockBands, n: int):
    """Whole blocks of `bb` over n shards, balanced by rows: the longest
    block first, each to the shard with the fewest rows so far (the
    lowest such shard on a tie). Returns per shard (its buckets, with
    slots renumbered over its own variants; the global ids of those
    variants, ascending; each of its blocks' place in bb's block order,
    buckets first, as `SweepBands` numbers them)."""
    blocks = [(int(r), k, b) for k, (_, gidx) in enumerate(bb.buckets)
              for b, r in enumerate((np.asarray(gidx) >= 0).sum(1))]
    if n > len(blocks):
        raise ValueError(f"{n} shards for {len(blocks)} LD blocks: a shard "
                         "needs at least one block")
    load, owner = [0] * n, [0] * len(blocks)
    for i in sorted(range(len(blocks)), key=lambda i: (-blocks[i][0], i)):
        owner[i] = min(range(n), key=lambda s: (load[s], s))
        load[owner[i]] += blocks[i][0]
    out = []
    for s in range(n):
        mine = [i for i in range(len(blocks)) if owner[i] == s]
        g = np.concatenate([np.asarray(bb.buckets[blocks[i][1]][1])
                            [blocks[i][2]] for i in mine])
        var = np.sort(g[g >= 0]).astype(np.int64)
        buckets = []
        for k, (bands, gidx) in enumerate(bb.buckets):
            sel = [blocks[i][2] for i in mine if blocks[i][1] == k]
            if sel:
                gk = np.asarray(gidx)[sel]
                loc = np.where(gk >= 0, np.searchsorted(var, gk), -1)
                buckets.append((np.asarray(bands)[sel],
                                loc.astype(np.int32)))
        out.append((buckets, var, np.asarray(mine, dtype=np.int64)))
    return out


def shard_block_bands(bb: BlockBands, devices, dtype=None):
    """`split_blocks` over the shard devices, each shard's bands on its
    device (cached on bb by shard count, shard, device and dtype): per
    shard (SweepBands, var, blk) with var and blk long tensors on its
    device."""
    from bigsnpr_tpu_torch import config

    if dtype is None:
        dtype = bb.buckets[0][0].dtype if bb.buckets else np.float32
    tdt = _TORCH_DTYPES[np.dtype(dtype)]
    out, split = [], None
    for i, d in enumerate(devices):
        dev = config.resolve_device(d)
        key = ("shard", len(devices), i, str(dev), tdt)
        if key not in bb._dev_cache:
            if split is None:
                split = split_blocks(bb, len(devices))
            buckets, var, blk = split[i]
            bb._dev_cache[key] = (
                gibbs_kernels.SweepBands(buckets, len(var), dev, tdt),
                torch.as_tensor(var, device=dev),
                torch.as_tensor(blk, device=dev))
        out.append(bb._dev_cache[key])
    return out


def gibbs_auto_blocked(sb, beta_hat, n_vec, log_var, p_init, h2_init, gen,
                       shrink_corr, p_bounds, alpha_bounds, mean_ld, burn_in,
                       num_iter, report_step=None, use_mle=True,
                       no_jump_sign=False):
    """One LDpred2-auto chain on the blocked bands:
    `gibbs_auto_blocked_multi` with one chain; a dict of unbatched
    tensors."""
    out = gibbs_auto_blocked_multi(
        sb, beta_hat, n_vec, log_var, [p_init], h2_init, [gen], shrink_corr,
        p_bounds, alpha_bounds, mean_ld, burn_in, num_iter,
        report_step=report_step, use_mle=use_mle, no_jump_sign=no_jump_sign)
    return {k: v[0] for k, v in out.items()}


# ---------------------------------------------------------------------------
# lassosum2 on the blocked bands
# ---------------------------------------------------------------------------

# sweeps between the host's reads of the grid points' done flags (a read
# is a device sync); the points are frozen once done, so the sweeps run
# after the last point is done change nothing
LASSO_CHECK_EVERY = 8


def lassosum_cd_blocked(sb, beta_hat, pf, lam, delta, dfmax, tol, maxiter):
    """Block-parallel lassosum2 coordinate descent for NG grid points at
    once: the JAX package's `lassosum_cd_blocked` under its vmap over the
    grid (`pgs/lassosum2.py`), identical to the unblocked CD on
    block-diagonal LD. pf (m,) penalty factors, lam / delta (NG,) the grid.

    Each sweep launches the sweep kernel's lassosum mode for the grid
    points still running. A point is done after the sweep in which its
    largest shift is <= tol, its non-zeros exceed dfmax or its sum of
    squares exceeds 2 sum(beta_hat^2) (diverged); from then on its betas
    and dp stay as they are, as the vmapped while_loop freezes them. The
    done flags live on the device; the host reads them every
    LASSO_CHECK_EVERY sweeps to stop early, never once a sweep. Returns (beta (NG, m), NaN rows where a point
    diverged; num_iter (NG,) int64, the sweeps each point ran)."""
    bh, pfv = _as(sb, beta_hat), _as(sb, pf)
    lam_t, del_t = _as(sb, lam), _as(sb, delta)
    NG, m = lam_t.shape[0], sb.m
    dev = sb.device
    gap0 = 2.0 * torch.sum(bh ** 2)
    dp = sb.dp0(NG)
    beta = torch.zeros((NG, m), dtype=sb.dtype, device=dev)
    active = torch.ones(NG, dtype=torch.bool, device=dev)
    diverged = torch.zeros(NG, dtype=torch.bool, device=dev)
    iters = torch.zeros(NG, dtype=torch.int64, device=dev)
    for k in range(maxiter):
        gap, df, ms = gibbs_kernels.lassosum_sweep(sb, dp, beta, bh, pfv,
                                                   lam_t, del_t, active)
        div = gap > gap0
        done = (ms <= tol) | (df > dfmax) | div
        iters += active
        diverged = torch.where(active, div, diverged)
        active = active & ~done
        if (k + 1) % LASSO_CHECK_EVERY == 0 and not bool(active.any()):
            break
    return torch.where(diverged[:, None], torch.nan, beta), iters
