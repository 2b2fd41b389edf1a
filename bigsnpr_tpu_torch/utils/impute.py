"""Genotype imputation (port of `bigsnpr_tpu/utils/impute.py`).

Reference: snp_fastImputeSimple (src/impute-simple.cpp:11-75): per-column
mode / rounded-mean / binomial-sample fill of missing hard calls; and
snp_fastImpute (R/impute.R:29-160): a per-variant local model on
correlated neighbours with a validation-error estimate and resumable
progress, here, as in the JAX package, a ridge regression ("ridge") or
boosted stumps on dosage classes ("boost") on the neighbour set that
`snp_cor` selects.

The simple modes decode, fill and repack on the device in row chunks from
integer counts, so every mode equals the JAX package's bit for bit;
"random" replays the JAX package's host stream, one `rng.binomial` over
all m x n entries in C order, drawn in row chunks (port DEVIATIONS #33).

The model blocks are XLA in the JAX package (`_impute_block_fn`,
`_impute_block_boost_fn`), so they port as torch ops: the packed window
decodes on the device, the ridge solves its normal equations as batched
products and a batched Cholesky (`cholesky_ex`: a failed factor leaves
its variant's predictions NaN, as JAX's `cho_factor` does), and the boost
forms its per-class counts and residual sums through the window's class
masks instead of a (B, 4, K, n) one-hot. The host logic (neighbour
table, windows, the train / validation draws, `info`) is the JAX
package's, copied; the imputed codes are written back per block on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core import unpack
from bigsnpr_tpu_torch.core.genotypes import GenoPack
from bigsnpr_tpu_torch.ops import precision
from bigsnpr_tpu_torch.ops.blocks import pick_block
from bigsnpr_tpu_torch.ops.corr import snp_cor
from bigsnpr_tpu_torch.ops.stats import snp_counts

# entries a chunk of the "random" mode draws on the host (int64 each)
_DRAW_ENTRIES = 1 << 23
# dosage 0 / 1 / 2 -> 2-bit code (np_dosage_to_codes); NA is code 1
_DOSE_CODE = (3, 2, 0)
# bed code -> CODE_DOSAGE byte (hard calls 0..2, NA 3)
_BED_TO_BYTE = (2, 3, 1, 0)
# the boost's candidate LEFT sets over classes {0, 1, 2, NA}
_LEFT = ((1, 0, 0, 0),    # {0}
         (1, 0, 0, 1),    # {0, NA}
         (1, 1, 0, 0),    # {0, 1}
         (1, 1, 0, 1))    # {0, 1, NA}


def _row_chunks(m, step):
    for r0 in range(0, m, step):
        yield r0, min(m, r0 + step)


def _code_rows(n):
    """Rows of 2-bit codes decoded at once on the device (uint8: 4x the
    float32 block, as snp_counts)."""
    return 4 * pick_block(n)


def _fill_packed(src, n, fill_of):
    """(m, nb) packed -> packed with every NA code replaced by the code
    that `fill_of(r0, r1)` gives for rows [r0, r1) (an (r, 1) or (r, n)
    uint8 tensor on the device), in row chunks."""
    out = torch.empty_like(src)
    for r0, r1 in _row_chunks(src.shape[0], _code_rows(n)):
        codes = unpack.unpack_codes(src[r0:r1], n)
        out[r0:r1] = unpack.pack_codes(torch.where(codes == 1,
                                                   fill_of(r0, r1), codes))
    return out


def _packed_result(pack, out, dev):
    res = GenoPack(packed=out.cpu().numpy(), n=pack.n, fam=pack.fam,
                   map=pack.map)
    res._device_cache[str(dev)] = out
    return res


def snp_fastImputeSimple(pack: GenoPack, method: str = "mode",
                         seed: int | None = None, device=None):
    """method in {mode, mean0, random, mean2}. Returns a new GenoPack with
    missing values filled ("mean2": a DosagePack, see
    `snp_fastImputeSimple_mean2`)."""
    if method == "mean2":
        return snp_fastImputeSimple_mean2(pack, device=device)
    if method not in ("mode", "mean0", "random"):
        raise ValueError("method should be 'mode', 'mean0' or 'random'.")
    dev = config.resolve_device(device)
    counts = snp_counts(pack, device=dev)
    c0, c1, c2 = (counts[k].astype(np.int64) for k in range(3))
    c = np.maximum(c0 + c1 + c2, 1)
    src = pack.device_packed(dev)
    lut = np.array(_DOSE_CODE, dtype=np.uint8)

    if method == "random":
        # the JAX package's one binomial draw over all (m, n) entries, in
        # C order, replayed in row chunks from the same generator
        rng = np.random.default_rng(seed)
        af = (0.5 * c1 + c2) / c
        n = pack.n

        def fill_of(r0, r1):
            fill = np.empty((r1 - r0, n), dtype=np.uint8)
            for a, b in _row_chunks(r1 - r0, max(1, _DRAW_ENTRIES // n)):
                draws = rng.binomial(2, np.broadcast_to(
                    af[r0 + a:r0 + b, None], (b - a, n)))
                fill[a:b] = lut[draws]
            return torch.from_numpy(fill).to(dev)
    else:
        if method == "mode":
            # reference order: start 0; 1 if c1>c0; 2 if c2>max-so-far
            imput = np.zeros(pack.m, dtype=np.int64)
            imput[c1 > c0] = 1
            imput = np.where((imput == 0) & (c2 > c0), 2, imput)
            imput = np.where((imput == 1) & (c2 > c1), 2, imput)
        else:
            imput = np.rint((c1 + 2.0 * c2) / c).astype(np.int64)
        fill = torch.as_tensor(lut[imput][:, None], device=dev)

        def fill_of(r0, r1):
            return fill[r0:r1]
    return _packed_result(pack, _fill_packed(src, pack.n, fill_of), dev)


def _mean2(pack, dev):
    """Per-variant non-missing mean rounded to 2 decimals, from counts."""
    counts = snp_counts(pack, device=dev)
    c = np.maximum(counts[:3].sum(0), 1)
    return np.round((counts[1] + 2.0 * counts[2]) / c, 2)


def snp_fastImputeSimple_dosage(pack: GenoPack, device=None) -> np.ndarray:
    """'mean2' mode: (n, m) float dosages with NA filled by the column mean
    rounded to 2 decimals (reference method 3, src/impute-simple.cpp:62-64).
    A dense host view, for small packs."""
    mean2 = _mean2(pack, config.resolve_device(device))
    X = pack.to_dosage()
    return np.where(np.isnan(X), mean2[None, :], X)


def snp_fastImputeSimple_mean2(pack: GenoPack, device=None):
    """'mean2' as a DosagePack (byte codes; hard calls stay exact, NA
    becomes the 2-decimal mean dosage code — the reference's +7-offset
    imputed code range, src/impute-simple.cpp:62-64), decoded and
    re-coded on the device in row chunks."""
    from bigsnpr_tpu_torch.core.dosage import DosagePack

    dev = config.resolve_device(device)
    mean2 = _mean2(pack, dev)
    # CODE_DOSAGE: hard calls at 0..2; dosage codes 7..207 map (code-7)/100
    dose = torch.as_tensor((7 + np.round(100 * mean2)).astype(np.uint8),
                           device=dev)
    lut = torch.tensor(_BED_TO_BYTE, dtype=torch.uint8, device=dev)
    src = pack.device_packed(dev)
    n = pack.n
    out = torch.empty((pack.m, n), dtype=torch.uint8, device=dev)
    for r0, r1 in _row_chunks(pack.m, _code_rows(n)):
        codes = unpack.unpack_codes(src[r0:r1], n)
        out[r0:r1] = torch.where(codes == 1, dose[r0:r1, None],
                                 lut[codes.long()])
    res = DosagePack(codes=out.cpu().numpy(), n=n, fam=pack.fam,
                     map=pack.map)
    res._device_cache[str(dev)] = out
    return res


# ---------------------------------------------------------------------------
# the model blocks: B variants at once on a (W, nb) packed window
# ---------------------------------------------------------------------------

def _impute_block_ridge(packed_win, n, nb_idx, nb_valid, y_idx, train,
                        ridge):
    """B simultaneous per-variant ridge regressions on up to K neighbour
    features drawn from a W-variant packed window (JAX `_impute_block_fn`).

    Inputs, on one device: packed_win (W, nb) uint8; nb_idx (B, K)
    window-local neighbour rows; nb_valid (B, K) {0, 1} float32; y_idx
    (B,) window-local target rows; train (B, n) {0, 1} float32. Returns
    (preds (B, n), y (B, n) dosages, y_na (B, n) bool), float32; its three
    products run at `config.matmul_precision` (`ops/precision.py`), as the
    JAX block's do. A variant
    whose normal equations do not factor (no training row: ntr = 0) gets
    NaN predictions, as JAX's `cho_factor` gives them."""
    d, na = unpack.unpack_dosage(packed_win, n)             # (W, n)
    cnt = (~na).sum(1).clamp(min=1).to(torch.float32)
    mean = d.sum(1) / cnt
    F = torch.where(na, mean[:, None], d)                   # mean-imputed
    y = d[y_idx]
    y_na = na[y_idx]
    t = train * (1.0 - y_na.to(torch.float32))    # never train on missing y
    B, K = nb_idx.shape
    A = torch.cat([torch.ones((B, 1, n), dtype=F.dtype, device=F.device),
                   F[nb_idx] * nb_valid[:, :, None]], dim=1)   # (B, K+1, n)
    Aw = A * t[:, None, :]
    prec = precision.resolve()
    G = precision.bmm(Aw, A.transpose(1, 2), prec)
    ntr = t.sum(1)
    G = G + (ridge * ntr)[:, None, None] * torch.eye(
        K + 1, dtype=G.dtype, device=G.device)
    b = precision.bmm(Aw, y[:, :, None], prec)
    L, info = torch.linalg.cholesky_ex(G)
    w = torch.cholesky_solve(b, L)                           # (B, K+1, 1)
    preds = precision.bmm(w.transpose(1, 2), A, prec)[:, 0]
    # what cholesky_solve gives on a failed factor is not defined
    preds = torch.where((info > 0)[:, None],
                        torch.full((), float("nan"), device=preds.device),
                        preds)
    return preds, y, y_na


def _impute_block_boost(packed_win, n, nb_idx, nb_valid, y_idx, train,
                        n_rounds=10, lr=0.5, reg_lambda=1.0,
                        return_splits=False):
    """Gradient-boosted stumps on dosage classes (JAX
    `_impute_block_boost_fn`), same inputs and outputs as
    `_impute_block_ridge`; with `return_splits` also the (n_rounds, B, 2)
    int64 split of each round: (candidate LEFT set, neighbour).

    Each round scores every (neighbour, LEFT set) from per-class residual
    sums S and counts C (B, 4, K). They come from one product a round of
    the window's class masks (4W, n) with the block's residuals (n, B),
    gathered at each variant's neighbours: no (B, 4, K, n) one-hot is
    formed. The argmax takes the first maximum over (candidate,
    neighbour), as jnp.argmax does."""
    codes = unpack.unpack_codes(packed_win, n)               # (W, n)
    na_all = codes == 1
    d_all = torch.where(na_all, 0, 2 - ((codes.to(torch.int32) + 1) >> 1)
                        ).to(torch.float32)
    cls_all = torch.where(na_all, 3, d_all.to(torch.int64))  # NA -> 3
    y = d_all[y_idx]
    y_na = na_all[y_idx]
    t = train * (1.0 - y_na.to(torch.float32))
    W = codes.shape[0]
    B, K = nb_idx.shape
    dev = codes.device
    classes = torch.arange(4, device=dev)
    masks = (cls_all[None] == classes[:, None, None]).to(
        torch.float32).reshape(4 * W, n)                     # row g W + w
    rows = (classes[None, :, None] * W + nb_idx[:, None, :])   # (B, 4, K)
    cols = torch.arange(B, device=dev)[:, None, None]
    valid = nb_valid[:, None, :]

    def class_sums(v):                                       # (B, n)
        T = masks @ v.T                                      # (4W, B)
        return T[rows, cols] * valid                         # (B, 4, K)

    left = torch.tensor(_LEFT, dtype=torch.float32, device=dev)
    lam = reg_lambda
    C = class_sums(t)
    CL = torch.einsum("cg,bgk->bck", left, C)
    CT = C.sum(1)[:, None]
    CR = CT - CL
    ntr = t.sum(1).clamp(min=1.0)
    pred = ((y * t).sum(1) / ntr)[:, None].expand(B, n).contiguous()
    bi = torch.arange(B, device=dev)
    splits = []
    for _ in range(n_rounds):
        S = class_sums((y - pred) * t)
        SL = torch.einsum("cg,bgk->bck", left, S)
        ST = S.sum(1)[:, None]
        SR = ST - SL
        gain = (SL ** 2 / (CL + lam) + SR ** 2 / (CR + lam)
                - ST ** 2 / (CT + lam))
        flat = gain.reshape(B, 4 * K).argmax(1)
        ci, ki = flat // K, flat % K
        wL = lr * SL[bi, ci, ki] / (CL[bi, ci, ki] + lam)
        wR = lr * SR[bi, ci, ki] / (CR[bi, ci, ki] + lam)
        in_left = left[ci[:, None], cls_all[nb_idx[bi, ki]]]  # (B, n)
        pred = pred + torch.where(in_left > 0, wL[:, None], wR[:, None])
        splits.append(torch.stack([ci, ki], 1))
    if return_splits:
        return pred, y, y_na, torch.stack(splits)
    return pred, y, y_na


def _neighbour_table(csc, len_chr, size, K):
    """Top-K neighbours by |r| from the symmetric CSC matrix, with the
    positional fallback when a variant has fewer than 5 (the JAX
    package's loop, R/impute.R's neighbour choice)."""
    nb_tab = np.zeros((len_chr, K), dtype=np.int32)
    nb_val = np.zeros((len_chr, K), dtype=np.float32)
    for i in range(len_chr):
        lo_p, hi_p = csc.indptr[i], csc.indptr[i + 1]
        neigh = csc.indices[lo_p:hi_p]
        r = np.abs(csc.data[lo_p:hi_p])
        if len(neigh) < 5:
            lo, hi = max(0, i - size), min(len_chr, i + size + 1)
            extra = np.setdiff1d(np.arange(lo, hi), np.r_[neigh, i])
            neigh = np.r_[neigh, extra]
            r = np.r_[r, np.full(len(extra), 1e-9)]
        if len(neigh) > K:
            top = np.argpartition(-r, K - 1)[:K]
            neigh = neigh[top]
        k = len(neigh)
        nb_tab[i, :k] = neigh
        nb_val[i, :k] = 1.0
    return nb_tab, nb_val


def _dosage_codes(f):
    """Rounded dosages {0, 1, 2, NaN} (float) -> 2-bit codes (uint8), as
    np_dosage_to_codes."""
    lut = torch.tensor(_DOSE_CODE, dtype=torch.uint8, device=f.device)
    nan = torch.isnan(f)
    return torch.where(nan, 1, lut[torch.where(nan, 0.0, f).long()]
                       ).to(torch.uint8)


def _write_back(packed_rows, n, preds, y_na):
    """The imputed rows: each row's NA codes replaced by its rounded,
    clipped prediction (NaN stays NA), repacked with zero pad bits; a row
    with no NA keeps its bytes as they were. The device counterpart of
    the JAX package's per-row unpack / assign / repack."""
    codes = unpack.unpack_codes(packed_rows, n)
    fill = _dosage_codes(torch.round(torch.clamp(preds, 0, 2)))
    new = unpack.pack_codes(torch.where(y_na, fill, codes))
    return torch.where(y_na.any(1)[:, None], new, packed_rows)


def snp_fastImpute(pack: GenoPack, infos_chr=None, alpha: float = 1e-4,
                   size: int = 200, p_train: float = 0.8,
                   n_cor: int | None = None, seed: int | None = None,
                   info: np.ndarray | None = None,
                   ridge: float = 1e-3, max_neighbors: int = 32,
                   block: int = 512, method: str = "ridge",
                   n_rounds: int = 10, device=None):
    """Model-based imputation on correlated neighbours (reference
    snp_fastImpute, R/impute.R:29-160, with the XGBoost model replaced as
    in the JAX package): method "ridge" (linear) or "boost" (boosted
    stumps on dosage classes, n_rounds rounds).

    Variants go in blocks of `block`: each block decodes its packed window
    on the device and fits all of its variants at once; the packed pack
    stays on the device and the imputed codes are written there. Returns
    (imputed GenoPack, info (2, m): [NA rate, validation error]); `info`
    passed back in resumes (it is updated in place, as in the JAX
    package)."""
    assert method in ("ridge", "boost"), method
    dev = config.resolve_device(device)
    rng = np.random.default_rng(seed)
    n, m = pack.n, pack.m
    if infos_chr is None:
        infos_chr = (pack.map["chromosome"]
                     if pack.map is not None else np.ones(m, dtype=int))
    infos_chr = np.asarray(infos_chr)
    if n_cor is None:
        n_cor = min(n, 5000)
    if info is None:
        info = np.full((2, m), np.nan)

    src = pack.device_packed(dev)
    new = src.clone()
    K = max_neighbors

    for chrom in np.unique(infos_chr):
        ind_chr = np.nonzero(infos_chr == chrom)[0]
        todo = np.isnan(info[0, ind_chr])
        if not todo.any():
            continue
        len_chr = len(ind_chr)
        ind_rows_cor = np.sort(rng.choice(n, size=n_cor, replace=False))
        corr = snp_cor(pack, ind_row=ind_rows_cor, ind_col=ind_chr,
                       size=size, alpha=alpha, fill_diag=False, device=dev)
        nb_tab, nb_val = _neighbour_table(corr.sym().tocsc(), len_chr, size,
                                          K)
        rows_chr = torch.as_tensor(ind_chr, device=dev)
        packed_chr = src[rows_chr]            # the chromosome, once
        Bsz = min(block, len_chr)
        W = min(len_chr, Bsz + 2 * size)
        done = []                             # (variants, device counts)
        for j0 in range(0, len_chr, Bsz):
            blk = np.arange(j0, min(j0 + Bsz, len_chr))
            need = todo[blk]
            if not need.any():
                continue
            win_lo = min(max(0, j0 - size), len_chr - W)
            # pad target list to Bsz (repeats are computed then ignored)
            tgt = np.resize(blk, Bsz)
            nb_loc = np.clip(nb_tab[tgt] - win_lo, 0, W - 1).astype(np.int32)
            valid = nb_val[tgt] * (np.abs(nb_tab[tgt] - win_lo - nb_loc) == 0)
            y_idx = (tgt - win_lo).astype(np.int32)
            # per-variant train / validation split (the host stream)
            u = rng.random((Bsz, n)).astype(np.float32)
            train_b = torch.from_numpy(u < p_train).to(dev)
            win = packed_chr[win_lo:win_lo + W]
            y_dev = torch.as_tensor(y_idx, device=dev).long()
            args = (win, n, torch.as_tensor(nb_loc, device=dev).long(),
                    torch.as_tensor(valid.astype(np.float32), device=dev),
                    y_dev, train_b.to(torch.float32))
            if method == "boost":
                preds, y, y_na = _impute_block_boost(*args,
                                                     n_rounds=n_rounds)
            else:
                preds, y, y_na = _impute_block_ridge(*args, ridge)

            sel = np.nonzero(need)[0]
            st = torch.as_tensor(sel, device=dev)
            p, yy, na = preds[st], y[st], y_na[st]
            rows = rows_chr[torch.as_tensor(blk[sel], device=dev)]
            new[rows] = _write_back(win[y_dev[st]], n, p, na)
            val = ~na & ~train_b[st]
            miss = (torch.round(torch.clamp(p, 0, 2)) != yy) & val
            done.append((ind_chr[blk[sel]], torch.stack(
                [na.sum(1), val.sum(1), miss.sum(1)])))

        for snps, counts in done:
            nbna, nval, nmiss = counts.cpu().numpy()
            ok = (nbna > 0) & (nval > 0)
            info[1, snps[ok]] = nmiss[ok] / nval[ok]
            info[0, snps] = nbna / n

    return _packed_result(pack, new, dev), info
