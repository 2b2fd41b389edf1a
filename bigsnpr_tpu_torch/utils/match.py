"""Allele matching between summary statistics and variant info.

Reference: snp_match / same_ref (R/match-alleles.R:50-200): join by
(chr, pos|rsid, a0, a1) after augmenting with strand flips (A<->T, C<->G;
ambiguous pairs removed) and allele reversals (beta -> -beta); duplicate
removal; min-match guard.

A port of `bigsnpr_tpu/utils/match.py` on dicts of numpy columns (port
DEVIATIONS #1). The JAX function expands the sumstats into four frames
(as is, flipped, reversed, both) and inner-merges them with pandas; here
the join is factorized keys in numpy: every key column of both tables is
coded once, the four expansions are index arrays with flags, and the
matches come out in pandas' order (the expanded rows in order, each
row's matches in the info table's order), then sorted stably by (chr,
pos). Rows, order, columns (with the merge's ".ss" suffix on the left),
`_NUM_ID_` and values are the JAX function's; it runs in seconds on
10^6 rows.
"""

from __future__ import annotations

import numpy as np

_FLIP = {"A": "T", "T": "A", "C": "G", "G": "C"}
_AMBIGUOUS = {("A", "T"), ("T", "A"), ("C", "G"), ("G", "C")}


def _table(obj) -> dict:
    """A dict of columns, a DataFrame or any mapping of arrays, as an
    ordered dict of numpy columns."""
    return {k: np.asarray(obj[k]) for k in list(obj.keys())}


def flip_strand(alleles) -> np.ndarray:
    """The complementary allele (A<->T, C<->G); None for any other."""
    a = np.asarray(alleles).astype(str)
    out = np.full(a.shape, None, dtype=object)
    for k, v in _FLIP.items():
        out[a == k] = v
    return out


def _kind(x: np.ndarray) -> str:
    return "num" if x.dtype.kind in "iufb" else "str"


def _codes(left, right):
    """Joint codes of two key columns: equal values, equal codes.
    Returns (codes of left, codes of right, number of codes)."""
    left, right = np.asarray(left), np.asarray(right)
    if _kind(left) != _kind(right):
        raise ValueError(f"cannot join a {left.dtype} key with a "
                         f"{right.dtype} one")
    if _kind(left) == "str":
        left, right = left.astype(str), right.astype(str)
    _, inv = np.unique(np.concatenate([left, right]), return_inverse=True)
    inv = inv.reshape(-1)
    return inv[:len(left)], inv[len(left):], int(inv.max(initial=-1)) + 1


def _combine(a, ka, b, kb):
    """Codes of pairs (a, b) with a < ka, b < kb, renumbered densely."""
    _, inv = np.unique(a.astype(np.int64) * kb + b, return_inverse=True)
    return inv.reshape(-1), int(inv.max(initial=-1)) + 1


def snp_match(sumstats, info_snp, strand_flip: bool = True,
              join_by_pos: bool = True, remove_dups: bool = True,
              match_min_prop: float = 0.2, return_flip_and_rev: bool = False,
              verbose: bool = True) -> dict:
    """Returns the matched table (a dict of numpy columns) with beta
    sign-corrected, plus `_NUM_ID_.ss` (row in sumstats) and `_NUM_ID_`
    (row in info_snp), both 1-based as in the reference."""
    ss = _table(sumstats)
    info = _table(info_snp)
    n_ss = len(next(iter(ss.values()))) if ss else 0
    n_info = len(next(iter(info.values()))) if info else 0
    ss["_NUM_ID_"] = np.arange(1, n_ss + 1)
    info["_NUM_ID_"] = np.arange(1, n_info + 1)
    min_match = match_min_prop * min(n_ss, n_info)

    key2 = "pos" if join_by_pos else "rsid"
    join_by = ["chr", key2, "a0", "a1"]
    if any(c not in ss for c in join_by + ["beta"]):
        raise ValueError(f"sumstats must have columns {join_by + ['beta']}")
    if any(c not in info for c in set(join_by + ["pos"])):
        raise ValueError(f"info_snp must have columns {join_by + ['pos']}")

    if verbose:
        print(f"{n_ss:,} variants to be matched.")

    # (chr, pos|rsid) coded jointly; pre-filter the sumstats on it
    cl, cr, kc = _codes(ss["chr"], info["chr"])
    pl, pr, kp = _codes(ss[key2], info[key2])
    loc, _ = _combine(np.concatenate([cl, cr]), kc,
                      np.concatenate([pl, pr]), kp)
    loc_ss, loc_info = loc[:n_ss], loc[n_ss:]
    rows = np.flatnonzero(np.isin(loc_ss, loc_info))
    if len(rows) == 0:
        raise ValueError("No variant has been matched.")

    # allele codes over every value either table or a strand flip can hold;
    # an allele with no complement flips to a code that matches nothing
    a0 = np.asarray(ss["a0"])[rows].astype(str)
    a1 = np.asarray(ss["a1"])[rows].astype(str)
    b0 = np.asarray(info["a0"]).astype(str)
    b1 = np.asarray(info["a1"]).astype(str)
    values, inv = np.unique(np.concatenate([a0, a1, b0, b1,
                                            np.array(list(_FLIP))]),
                            return_inverse=True)
    inv = inv.reshape(-1)
    ka = len(values) + 1
    none = ka - 1
    nr = len(rows)
    c_a0, c_a1 = inv[:nr], inv[nr:2 * nr]
    c_b0, c_b1 = inv[2 * nr:2 * nr + n_info], inv[2 * nr + n_info:
                                                   2 * nr + 2 * n_info]
    flip = np.full(ka, none, dtype=np.int64)
    for k, v in _FLIP.items():
        flip[np.searchsorted(values, k)] = np.searchsorted(values, v)

    # the expansion: as is, then flipped (non-ambiguous rows only), each
    # then reversed, as index arrays into `rows` with their flags
    if strand_flip:
        amb = np.zeros(nr, dtype=bool)
        for x, y in _AMBIGUOUS:
            amb |= (a0 == x) & (a1 == y)
        if verbose:
            print(f"{int(amb.sum()):,} ambiguous SNPs have been removed.")
        keep = np.flatnonzero(~amb)
        idx3 = np.concatenate([keep, keep])
        flip3 = np.repeat([False, True], len(keep))
    else:
        idx3 = np.arange(nr)
        flip3 = np.zeros(nr, dtype=bool)
    idx4 = np.concatenate([idx3, idx3])
    flip4 = np.concatenate([flip3, flip3])
    rev4 = np.repeat([False, True], len(idx3))
    x0, x1 = c_a0[idx4], c_a1[idx4]
    x0 = np.where(flip4, flip[x0], x0)
    x1 = np.where(flip4, flip[x1], x1)
    x0, x1 = np.where(rev4, x1, x0), np.where(rev4, x0, x1)

    # inner join: each expanded row's matches in the info table's order
    key_l = (loc_ss[rows][idx4] * ka + x0) * ka + x1
    key_r = (loc_info.astype(np.int64) * ka + c_b0) * ka + c_b1
    order = np.argsort(key_r, kind="stable")
    sorted_r = key_r[order]
    lo = np.searchsorted(sorted_r, key_l, side="left")
    hi = np.searchsorted(sorted_r, key_l, side="right")
    cnt = hi - lo
    li = np.repeat(np.arange(len(key_l)), cnt)
    start = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
    ri = order[start + np.arange(len(li))]

    src = rows[idx4[li]]          # the sumstats row of each match
    flips, revs = flip4[li], rev4[li]
    left_cols = [c for c in ss] + ["_FLIP_", "_REV_"]
    right_cols = [c for c in info if c not in join_by]
    out = {}
    for c in left_cols:
        if c == "_FLIP_":
            v = flips
        elif c == "_REV_":
            v = revs
        elif c in ("a0", "a1"):
            v = np.asarray(info[c])[ri]     # the join's keys: equal
        elif c == "beta":
            b = np.asarray(ss[c])[src]
            v = np.where(revs, -b, b)
        else:
            v = np.asarray(ss[c])[src]
        out[c + ".ss" if c in right_cols else c] = v
    for c in right_cols:
        out[c] = np.asarray(info[c])[ri]

    n_match = len(li)
    if remove_dups:
        cc, _, k1 = _codes(out["chr"], out["chr"][:0])
        pc, _, k2 = _codes(out["pos"], out["pos"][:0])
        site, ks = _combine(cc, k1, pc, k2)
        dup = np.bincount(site, minlength=ks)[site] > 1
        if dup.any():
            out = {k: v[~dup] for k, v in out.items()}
            n_match = int((~dup).sum())
            if verbose:
                print("Some duplicates were removed.")

    if verbose:
        print(f"{n_match:,} variants have been matched; "
              f"{int(out['_FLIP_'].sum()):,} were flipped and "
              f"{int(out['_REV_'].sum()):,} were reversed.")
    if n_match < min_match:
        raise ValueError("Not enough variants have been matched.")

    if not return_flip_and_rev:
        del out["_FLIP_"], out["_REV_"]
    perm = np.lexsort((out["pos"], out["chr"]))
    return {k: v[perm] for k, v in out.items()}


def same_ref(ref1, alt1, ref2, alt2):
    """Whether reference alleles are the same, strand-flip-aware
    (reference same_ref, R/match-alleles.R:156-200). Returns float array
    with NaN for ambiguous/invalid."""
    rev = _FLIP

    def decide(r1, a1, r2, a2):
        vals = (r1, a1, r2, a2)
        if any(v not in "ACTG" for v in map(str, vals)):
            return np.nan
        if r1 == a1 or r2 == a2:
            return np.nan
        # priority order of the reference's case_when (R/match-alleles.R:162-175)
        if (r1 == r2) and (a1 == a2):
            return 1.0
        if (r1 == a2) and (a1 == r2):
            return 0.0
        if (rev[r1] == r2) and (rev[a1] == a2):
            return 1.0
        if (rev[r1] == a2) and (rev[a1] == r2):
            return 0.0
        return np.nan

    out = [decide(str(r1), str(a1), str(r2), str(a2))
           for r1, a1, r2, a2 in zip(ref1, alt1, ref2, alt2)]
    return np.asarray(out, dtype=np.float64)


def snp_asGeneticPos(infos_chr, infos_pos, genetic_map=None, rsid=None,
                     method: str = "nn") -> np.ndarray:
    """Interpolate genetic positions (cM) from a genetic map.

    Reference: snp_asGeneticPos (R/modify-positions.R:115-160): nearest-
    neighbor position lookup by default; when `rsid` is provided, exact
    rsid matches take the map value and the rest are interpolated with a
    monotone (Hyman) spline — PCHIP here, also monotone. method="linear"
    gives snp_asGeneticPos2 semantics (R/modify-positions.R:246-267).

    genetic_map: a dict of columns (or a DataFrame) with pos, pos_cM
    (+ optional chr, rsid). Without a map, returns pos / 1e6 (1 cM/Mb
    approximation)."""
    infos_chr = np.asarray(infos_chr)
    infos_pos = np.asarray(infos_pos, dtype=np.float64)
    if genetic_map is None:
        return infos_pos / 1e6
    out = np.empty(len(infos_pos))
    gm_pos = np.asarray(genetic_map["pos"], dtype=np.float64)
    gm_cm = np.asarray(genetic_map["pos_cM"], dtype=np.float64)
    gm_chr = (np.asarray(genetic_map["chr"]) if "chr" in genetic_map
              else np.ones(len(gm_pos)))
    for chrom in np.unique(infos_chr):
        sel = infos_chr == chrom
        gsel = gm_chr == chrom
        xp, fp = gm_pos[gsel], gm_cm[gsel]
        ord_ = np.argsort(xp)
        xp, fp = xp[ord_], fp[ord_]
        q = infos_pos[sel]
        if rsid is not None and "rsid" in genetic_map:
            pos_cm = np.full(sel.sum(), np.nan)
            map_rsid = np.asarray(genetic_map["rsid"])[gsel][ord_]
            lookup = dict(zip(map_rsid.tolist(), fp))
            qr = np.asarray(rsid)[sel]
            for i, rs in enumerate(qr.tolist()):
                if rs in lookup:
                    pos_cm[i] = lookup[rs]
            todo = np.isnan(pos_cm)
            if todo.any():
                from scipy.interpolate import PchipInterpolator

                uniq, iu = np.unique(xp, return_index=True)
                spl = PchipInterpolator(uniq, fp[iu], extrapolate=True)
                pos_cm[todo] = spl(q[todo])
            out[sel] = pos_cm
        elif method == "nn":
            idx = np.searchsorted(xp, q)
            idx = np.clip(idx, 1, len(xp) - 1)
            left_closer = np.abs(xp[idx - 1] - q) <= np.abs(xp[idx] - q)
            out[sel] = fp[np.where(left_closer, idx - 1, idx)]
        else:
            out[sel] = np.interp(q, xp, fp)
    return out


def snp_asGeneticPos2(infos_chr, infos_pos, genetic_map=None):
    """Linear-interpolation variant (reference snp_asGeneticPos2,
    R/modify-positions.R:246-267)."""
    return snp_asGeneticPos(infos_chr, infos_pos, genetic_map,
                            method="linear")
