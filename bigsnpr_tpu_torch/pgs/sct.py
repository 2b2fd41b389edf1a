"""Stacked Clumping + Thresholding (SCT) (port of `bigsnpr_tpu/pgs/sct.py`).

Reference: snp_grid_clumping / snp_grid_PRS / snp_grid_stacking
(R/SCT.R:32-304). As in the JAX package, the grid clumping computes the
banded r^2 ONCE per chromosome at the widest window and re-runs the
greedy on the conflict graph per grid cell, where the reference shares a
memoized per-pair r^2 cache across the (size x thr) cells
(src/clumping-cached.cpp). Here the r^2 is the float64 r of the exact
integer pair sums, computed on the device, and only the pairs above the
grid's smallest threshold reach the host; each cell's greedy is the
native O(m + E) walk of `ops/clumping.py`.

Tables are dicts of numpy columns (the JAX package returns DataFrames).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.linalg.penalized import big_spReg
from bigsnpr_tpu_torch.ops.clumping import _greedy_fixed_point
from bigsnpr_tpu_torch.ops.corr import (_window_geometry, _window_r2,
                                        band_blocks)
from bigsnpr_tpu_torch.ops.matvec import snp_prodVec
from bigsnpr_tpu_torch.pgs.lassosum2 import seq_log

GRID_COLUMNS = ("size", "thr.r2", "grp.num", "thr.imp")


def _chrom_key(c):
    """Canonical all_keep key: int when the label parses as one,
    otherwise the string ('X', 'MT', ...)."""
    try:
        return int(c)
    except (TypeError, ValueError):
        return str(c)


def _chrom_order(all_keep):
    """all_keep's chromosomes in score-column order: integer labels
    ascending, then string labels ('X', 'MT', ...) ascending. The JAX
    package calls sorted(), the same order where the labels are all of
    one kind, and a TypeError on a mix such as 1..22 and 'X'."""
    return sorted(all_keep, key=lambda c: (isinstance(c, str), str(c))
                  if isinstance(c, str) else (False, c))


def _banded_r2(sub, pos, max_size, block=512, thr_r2_floor=0.0,
               device=None):
    """All window pairs (i < j, |pos_i - pos_j| <= max_size) with r^2 >
    thr_r2_floor, as numpy (i, j, r^2): the pairs below the grid's
    smallest threshold are used by no cell, and never leave the device.
    A DosagePack's r^2 come from its float64 byte-path sums (the JAX
    package's host-finalize path, which on a DosagePack raises there:
    port DEVIATIONS #27)."""
    dev = config.resolve_device(device)
    left_start = _window_geometry(pos, max_size)
    blocks, _ = band_blocks(sub, dev, left_start, block)
    ls_dev = torch.as_tensor(left_start, device=dev)
    ei, ej, r2 = [], [], []
    for t0, t1, b0, sums in blocks:
        i, j, v = _window_r2(sums, t0, t1, b0, ls_dev, thr_r2_floor)
        if len(i):
            ei.append(i)
            ej.append(j)
            r2.append(v)
    if not ei:
        z = np.array([], dtype=np.int64)
        return z, z, np.array([])
    return np.concatenate(ei), np.concatenate(ej), np.concatenate(r2)


def snp_grid_clumping(
    pack, infos_chr, infos_pos, lpS,
    ind_row=None,
    grid_thr_r2=(0.01, 0.05, 0.1, 0.2, 0.5, 0.8, 0.95),
    grid_base_size=(50, 100, 200, 500),
    infos_imp=None, grid_thr_imp=(1,),
    groups=None, exclude=None, block=512, device=None,
):
    """Grid of clumpings (reference snp_grid_clumping, R/SCT.R:32-151).

    Returns (all_keep: {chr: [kept index arrays, grid-ordered]}, grid: a
    dict of numpy columns size / thr.r2 / grp.num / thr.imp, one row a
    cell: size fastest, then thr.r2, then group, then thr.imp)."""
    dev = config.resolve_device(device)
    m_all = pack.m
    infos_chr = np.asarray(infos_chr)
    infos_pos = np.asarray(infos_pos, dtype=np.float64)
    lpS = np.asarray(lpS, dtype=np.float64)
    infos_imp = (np.ones(m_all) if infos_imp is None
                 else np.asarray(infos_imp, dtype=np.float64))
    groups = ([np.arange(m_all)] if groups is None
              else [np.asarray(g) for g in groups])

    THR_IMP = np.sort(np.unique(grid_thr_imp))
    THR_CLMP = np.sort(np.unique(grid_thr_r2))
    BASE_SIZE = np.sort(np.unique(grid_base_size))

    rows = [(int(base / thr), thr, g + 1, thr_imp)
            for thr_imp in THR_IMP for g in range(len(groups))
            for thr in THR_CLMP for base in BASE_SIZE]
    grid = {name: np.array([r[k] for r in rows])
            for k, name in enumerate(GRID_COLUMNS)}

    ind_noexcl = np.arange(m_all)
    if exclude is not None:
        ind_noexcl = np.setdiff1d(ind_noexcl, np.asarray(exclude))

    max_size = 1000.0 * BASE_SIZE.max() / THR_CLMP.min()

    all_keep = {}
    for chrom in np.unique(infos_chr[ind_noexcl]):
        ind_chr0 = ind_noexcl[infos_chr[ind_noexcl] == chrom]
        keep_list = []
        sub0 = pack.subset(ind_row=ind_row, ind_col=ind_chr0, device=dev)
        pos0 = infos_pos[ind_chr0]
        assert np.all(np.diff(pos0) >= 0), "positions must be sorted"
        # one banded r^2 at the widest window for the whole grid
        ei0, ej0, r20 = _banded_r2(sub0, pos0, max_size, block=block,
                                   thr_r2_floor=float(THR_CLMP.min()),
                                   device=dev)

        for thr_imp in THR_IMP:
            sel_imp = infos_imp[ind_chr0] >= thr_imp
            for group in groups:
                in_grp = sel_imp & np.isin(ind_chr0, group)
                idx = np.nonzero(in_grp)[0]       # local indices in chr
                if len(idx) == 0:
                    keep_list.extend(np.array([], dtype=np.int64)
                                     for _ in range(len(THR_CLMP)
                                                    * len(BASE_SIZE)))
                    continue
                remap = np.full(len(ind_chr0), -1, dtype=np.int64)
                remap[idx] = np.arange(len(idx))
                emask = in_grp[ei0] & in_grp[ej0]
                ei, ej, r2 = remap[ei0[emask]], remap[ej0[emask]], r20[emask]
                pos_g = pos0[idx]
                S_g = lpS[ind_chr0[idx]]
                ord_ = np.argsort(-S_g, kind="stable")
                rank = np.empty(len(idx), dtype=np.int64)
                rank[ord_] = np.arange(len(idx))
                dist = np.abs(pos_g[ej] - pos_g[ei])

                for thr in THR_CLMP:
                    for base in BASE_SIZE:
                        size_bp = 1000.0 * base / thr
                        sel = (dist <= size_bp) & (r2 > thr)
                        keep = _greedy_fixed_point(
                            len(idx), rank, ei[sel], ej[sel])
                        keep_list.append(ind_chr0[idx[keep]])
        all_keep[_chrom_key(chrom)] = keep_list
    return all_keep, grid


@dataclass
class GridPRS:
    """C+T scores for the whole grid (the reference's multi_PRS FBM +
    attributes, R/SCT.R:236-245). `scores` may be an on-disk float32
    memmap (see snp_grid_PRS backingfile=), the FBM analog."""

    scores: np.ndarray          # (n, n_keep_sets * n_thr)
    lpS: np.ndarray
    grid_lpS_thr: np.ndarray
    betas: np.ndarray
    all_keep: dict
    backingfile: str | None = None

    def save(self, path) -> str:
        """Persist metadata next to the backing store so a later session
        can re-attach (reference saves the RDS immediately after filling
        the FBM, R/SCT.R:244); the JAX package's file format. Returns the
        metadata path."""
        path = str(path)
        if not path.endswith(".meta.npz"):
            path = path + ".meta.npz"
        chroms = _chrom_order(self.all_keep)
        keep_flat = [k for c in chroms for k in self.all_keep[c]]
        np.savez_compressed(
            path,
            lpS=self.lpS, grid_lpS_thr=self.grid_lpS_thr, betas=self.betas,
            chroms=np.asarray(chroms),
            keep_counts=np.asarray([len(self.all_keep[c]) for c in chroms]),
            keep_lens=np.asarray([len(k) for k in keep_flat]),
            keep_cat=(np.concatenate(keep_flat) if keep_flat
                      else np.array([], dtype=np.int64)),
            backingfile=np.asarray(self.backingfile or ""),
            scores_inline=(self.scores if self.backingfile is None
                           else np.array([])),
        )
        if self.backingfile is not None and hasattr(self.scores, "flush"):
            self.scores.flush()
        return path

    @classmethod
    def load(cls, path, writable: bool = False) -> "GridPRS":
        path = str(path)
        if not path.endswith(".meta.npz"):
            path = path + ".meta.npz"
        z = np.load(path, allow_pickle=False)
        keep_flat = []
        off = 0
        for ln in z["keep_lens"]:
            keep_flat.append(z["keep_cat"][off:off + ln])
            off += ln
        all_keep = {}
        i = 0
        for c, cnt in zip(z["chroms"], z["keep_counts"]):
            # keep non-integer chromosome labels ('X', 'MT', ...)
            all_keep[_chrom_key(c)] = keep_flat[i:i + cnt]
            i += cnt
        bf = str(z["backingfile"])
        if bf and not os.path.exists(bf):
            # relocatable: look next to the metadata file (reference
            # R/read-plink.R:135-137 attach semantics)
            cand = os.path.join(os.path.dirname(path), os.path.basename(bf))
            if os.path.exists(cand):
                bf = cand
        # read-only attach by default (writable=True for 'r+')
        scores = (np.load(bf, mmap_mode="r+" if writable else "r") if bf
                  else z["scores_inline"])
        return cls(scores=scores, lpS=z["lpS"],
                   grid_lpS_thr=z["grid_lpS_thr"], betas=z["betas"],
                   all_keep=all_keep, backingfile=bf or None)


def grid_group_size(m, n_thr):
    """Grid cells a product of snp_grid_PRS takes: a float64 (m, cells x
    n_thr) weight matrix of ~512 MB (the JAX package's group size; ROADMAP
    queue 3: it ignores n)."""
    return max(1, int((512 << 20) // max(1, m * 8 * n_thr)))


def grid_weights(m, cells, betas, lpS, grid_lpS_thr):
    """The (m, len(cells) x n_thr) weight matrix of one group of grid
    cells: each cell's betas masked by each threshold, in its own n_thr
    columns; None when every cell is empty."""
    n_thr = len(grid_lpS_thr)
    B = np.zeros((m, len(cells) * n_thr))
    any_nz = False
    for ci, ind_keep in enumerate(cells):
        if len(ind_keep) == 0:
            continue
        any_nz = True
        mask = lpS[ind_keep, None] > grid_lpS_thr[None, :]
        B[ind_keep, ci * n_thr:(ci + 1) * n_thr] = betas[ind_keep, None] * mask
    return B if any_nz else None


def snp_grid_PRS(pack, all_keep, betas, lpS, n_thr_lpS=50, grid_lpS_thr=None,
                 ind_row=None, backingfile=None, device=None) -> GridPRS:
    """Reference snp_grid_PRS (R/SCT.R:201-246).

    The grid cells go in groups into full-width products through
    `snp_prodVec` (kernel K2 on CUDA): each cell's threshold masks fold
    into its columns of one (m, cells x n_thr) weight matrix of ~512 MB.
    backingfile: path for an on-disk float32 score store (the reference's
    FBM at R/SCT.R:244), written one group at a time; a half-written
    store is deleted on failure."""
    dev = config.resolve_device(device)
    betas = np.asarray(betas, dtype=np.float64)
    lpS = np.asarray(lpS, dtype=np.float64)
    if grid_lpS_thr is None:
        grid_lpS_thr = 0.9999 * seq_log(
            max(0.1, np.nanmin(lpS)), np.nanmax(lpS), n_thr_lpS)
    grid_lpS_thr = np.asarray(grid_lpS_thr)
    n_thr = len(grid_lpS_thr)

    keep_sets = [k for chrom in _chrom_order(all_keep)
                 for k in all_keep[chrom]]
    sub = (pack if ind_row is None
           else pack.subset(ind_row=np.asarray(ind_row), device=dev))
    shape = (sub.n, len(keep_sets) * n_thr)
    if backingfile is not None:
        backingfile = str(backingfile)
        if not backingfile.endswith(".npy"):
            backingfile = backingfile + ".npy"
        if os.path.exists(backingfile):
            raise FileExistsError(backingfile)
        scores = np.lib.format.open_memmap(
            backingfile, mode="w+", dtype=np.float32, shape=shape)
    else:
        scores = np.zeros(shape, dtype=np.float32)
    try:
        group = grid_group_size(sub.m, n_thr)
        for g0 in range(0, len(keep_sets), group):
            cells = keep_sets[g0:g0 + group]
            B = grid_weights(sub.m, cells, betas, lpS, grid_lpS_thr)
            if B is None:
                continue
            scores[:, g0 * n_thr:(g0 + len(cells)) * n_thr] = snp_prodVec(
                sub, B, device=dev)
    except BaseException:
        if backingfile is not None:
            del scores
            os.unlink(backingfile)
        raise
    if backingfile is not None:
        scores.flush()
    return GridPRS(scores=scores, lpS=lpS, grid_lpS_thr=grid_lpS_thr,
                   betas=betas, all_keep=all_keep, backingfile=backingfile)


def snp_grid_stacking(multi_PRS: GridPRS, y_train,
                      alphas=(1.0, 0.01, 0.0001), **kw):
    """Reference snp_grid_stacking (R/SCT.R:266-304): penalized stacking
    over all grid scores (`big_spReg`, native CD), then the stacking
    weights unrolled back to per-variant effects by the cumulative-sum
    trick (R/SCT.R:287-295). Returns a dict: intercept, beta.G,
    beta.covar, mod."""
    y_train = np.asarray(y_train, dtype=np.float64)
    lpS = multi_PRS.lpS
    lpS_thr = multi_PRS.grid_lpS_thr
    beta_gwas = multi_PRS.betas
    all_keep = multi_PRS.all_keep

    # nested C+T threshold columns are near-collinear: bigstatsr-class
    # eps (1e-5 on standardized scale) instead of the 1e-7 default
    kw.setdefault("tol", 1e-5)
    mod = big_spReg(multi_PRS.scores, y_train, alphas=alphas, **kw)
    beta_stacking = mod.beta

    # a variant contributes to every threshold column with thr < its lpS,
    # so its unrolled weight is the cumsum of the stacking weights over
    # the thresholds it passes
    ind_last_thr = 1 + (lpS[:, None] > lpS_thr[None, :]).sum(1)
    coef = np.zeros(len(beta_gwas))
    n_thr = len(lpS_thr)
    offset = 0
    for chrom in _chrom_order(all_keep):
        for ind_keep in all_keep[chrom]:
            b = beta_stacking[offset:offset + n_thr]
            b2 = np.r_[0, np.cumsum(b)]
            if len(ind_keep):
                coef[ind_keep] += b2[ind_last_thr[ind_keep] - 1]
            offset += n_thr
    return {
        "intercept": mod.intercept,
        "beta.G": coef * beta_gwas,
        "beta.covar": np.array([]),
        "mod": mod,
    }
