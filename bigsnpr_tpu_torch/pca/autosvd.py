"""autoSVD: truncated SVD with iterative long-range-LD removal (port of
`bigsnpr_tpu/pca/autosvd.py`).

Reference: snp_autoSVD / bed_autoSVD (R/autoSVD.R:67-186, 226-339):
MAF/MAC filter -> initial clumping -> loop { randomSVD -> robust outlier
statistic sqrt(dist_ogk(V)) -> per-chromosome rolling-mean smoothing ->
medcouple-adjusted Tukey threshold -> drop outliers, record contiguous
intervals as LRLD regions } until convergence or max_iter.

The SVD runs the genotype operator masked to the kept variants on the
whole cached pack (kernels K1/K2, or K6 under `config.pallas_mxu =
"int8"`); the outlier statistics are host numpy, as in the JAX package.
`lrldr` is a dict of numpy columns {Chr, Start, Stop, Iter}, sorted by
(Chr, Start, Stop) as the JAX package sorts its DataFrame.
"""

from __future__ import annotations

import numpy as np

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.linalg.randomsvd import BigSVD, snp_randomSVD
from bigsnpr_tpu_torch.ops.clumping import snp_clumping
from bigsnpr_tpu_torch.ops.stats import bed_MAF, bed_scaleBinom
from bigsnpr_tpu_torch.pca.robust import dist_ogk, rollmean, tukey_mc_up
from bigsnpr_tpu_torch.utils.assertions import check_args
from bigsnpr_tpu_torch.utils.profiling import StageTimer

LRLDR_COLS = ("Chr", "Start", "Stop", "Iter")


def get_intervals(x: np.ndarray, n: int = 2) -> np.ndarray:
    """Regroup consecutive integers into [start, stop] intervals with at
    least n members (reference getIntervals, R/autoSVD.R:4-12)."""
    x = np.asarray(x)
    if len(x) == 0:
        return np.empty((0, 2), dtype=x.dtype)
    breaks = np.nonzero(np.diff(x) != 1)[0]
    starts = np.r_[0, breaks + 1]
    stops = np.r_[breaks, len(x) - 1]
    keep = (stops - starts + 1) >= n
    return np.stack([x[starts[keep]], x[stops[keep]]], axis=1)


def _lrldr_table(rows, chr_dtype, pos_dtype) -> dict:
    """Rows (Chr, Start, Stop, Iter) as a dict of numpy columns, sorted
    stably by (Chr, Start, Stop)."""
    cols = [np.array([r[i] for r in rows], dtype=dt) for i, dt in
            enumerate((chr_dtype, pos_dtype, pos_dtype, np.int64))]
    order = np.lexsort((cols[2], cols[1], cols[0]))
    return {k: c[order] for k, c in zip(LRLDR_COLS, cols)}


@check_args()
def snp_autoSVD(
    pack,
    infos_chr=None,
    infos_pos=None,
    ind_row=None,
    ind_col=None,
    fun_scaling=bed_scaleBinom,
    thr_r2: float | None = 0.2,
    size: float | None = None,
    k: int = 10,
    roll_size: int = 50,
    int_min_size: int = 20,
    alpha_tukey: float = 0.05,
    min_mac: int = 10,
    min_maf: float = 0.02,
    max_iter: int = 5,
    verbose: bool = False,
    svd_kwargs: dict | None = None,
    timer=None,
    device=None,
) -> BigSVD:
    """Reference snp_autoSVD (R/autoSVD.R:67-186).

    timer: an optional `StageTimer` accumulating per-stage wall times
    (maf / clumping / svd / outliers); also attached to the result as
    .stage_times. The result carries .subset (kept variants) and .lrldr."""
    dev = config.resolve_device(device)
    if timer is None:
        timer = StageTimer()
    m_all = pack.m
    if infos_chr is None:
        infos_chr = (pack.map["chromosome"]
                     if pack.map is not None else np.ones(m_all, dtype=int))
    infos_chr = np.asarray(infos_chr)
    if infos_pos is not None:
        infos_pos = np.asarray(infos_pos)
    if ind_col is None:
        ind_col = np.arange(m_all)
    else:
        ind_col = np.asarray(ind_col)
    if size is None:
        size = 100 / thr_r2 if thr_r2 and not np.isnan(thr_r2) else 500

    def log(msg):
        if verbose:
            print(msg)

    # MAF/MAC filter (reference R/autoSVD.R:96-105 / :250-259)
    if not (min_mac > 0 and min_maf > 0):
        raise ValueError("set min_mac > 0 and min_maf > 0 "
                         "(cannot use variants with no variation)")
    with timer.stage("maf"):
        info = bed_MAF(pack, ind_row=ind_row, device=dev)
    maf_nok = ((info["mac"][ind_col] < min_mac)
               | (info["maf"][ind_col] < min_maf))
    log(f"Discarding {maf_nok.sum()} variants with MAC < {min_mac} or MAF < {min_maf}.")
    ind_keep = ind_col[~maf_nok]

    # initial clumping on MAF (reference R/autoSVD.R:107-120)
    if thr_r2 is not None and not np.isnan(thr_r2):
        log(f"Clumping (on MAF) at r^2 > {thr_r2}..")
        exclude = np.setdiff1d(np.arange(m_all), ind_keep)
        with timer.stage("clumping"):
            ind_keep = snp_clumping(
                pack, infos_chr=infos_chr, ind_row=ind_row, thr_r2=thr_r2,
                size=size, infos_pos=infos_pos, exclude=exclude, device=dev)
        log(f"keep {len(ind_keep)} variants.")

    lrldr_rows = []
    it = 0
    while True:
        it += 1
        log(f"Iteration {it}: computing SVD..")
        with timer.stage("svd"):
            obj_svd = snp_randomSVD(pack, fun_scaling=fun_scaling,
                                    ind_row=ind_row, ind_col=ind_keep, k=k,
                                    device=dev, **(svd_kwargs or {}))
        if it > max_iter:
            log("Maximum number of iterations reached.")
            break

        # outlier variants (reference R/autoSVD.R:142-151)
        with timer.stage("outliers"):
            S_col = np.sqrt(dist_ogk(obj_svd.v))
            S2_col = np.empty_like(S_col)
            for chrom in np.unique(infos_chr[ind_keep]):
                ind = np.nonzero(infos_chr[ind_keep] == chrom)[0]
                S2_col[ind] = rollmean(S_col[ind], roll_size)
            thr = tukey_mc_up(S2_col, alpha=alpha_tukey)
            ind_excl = np.nonzero(S2_col > thr)[0]
        log(f"{len(ind_excl)} outlier variants detected..")

        if len(ind_excl) == 0:
            log("Converged!")
            break

        if infos_pos is not None:
            for start, stop in get_intervals(ind_excl, n=int_min_size):
                seq_range = np.arange(start, stop + 1)
                chrs = infos_chr[ind_keep[seq_range]]
                vals, cnt = np.unique(chrs, return_counts=True)
                mode_chr = vals[np.argmax(cnt)]
                in_chr = chrs == mode_chr
                rng = infos_pos[ind_keep[seq_range[in_chr]]]
                lrldr_rows.append((mode_chr, rng.min(), rng.max(), it))
        ind_keep = np.delete(ind_keep, ind_excl)

    obj_svd.subset = ind_keep
    obj_svd.stage_times = timer.times
    obj_svd.lrldr = _lrldr_table(
        lrldr_rows, infos_chr.dtype,
        infos_pos.dtype if infos_pos is not None else np.int64)
    return obj_svd


def bed_autoSVD(pack, **kw) -> BigSVD:
    """Reference bed_autoSVD (R/autoSVD.R:226-339); same engine here."""
    return snp_autoSVD(pack, **kw)
