"""Windowed sparse LD correlation (port of `bigsnpr_tpu/ops/corr.py`).

Reference semantics (src/corr.cpp:11-97, R/corr.R:3-57): for each variant
j0, scan left neighbours j with pos[j] >= pos[j0] - size; pairwise-complete
Pearson r with NA-aware sums; keep if |r| > max(t-test threshold THR[nona],
sqrt(thr_r2)) or r is NaN; clamp to [-1, 1]; assemble an upper-triangular
sparse matrix.

For a block of B target variants and its left band of Wb variants, the six
NA-aware pair sums are six of the nine blocks of one stacked product

    [x*mx; x^2*mx; mx] @ [y*my; y^2*my; my]^T      (3B x n)(n x 3Wb)

and an NA-free pack needs only the x @ y^T plane plus per-variant sums.
Dosages are small integers, so the product is exact by construction: int8
operands with int32 accumulation (`torch._int_mm`) while the largest sum
fits in int32, a float64 product past that. The integer sums equal the JAX
package's bit for bit; `finalize="host"` computes r in float64 on the host
exactly as it does, `finalize="device"` computes the same float64 formula
on the device and rounds the kept values to float32 (the JAX package's
device values are float32 too).

A byte-coded `DosagePack` takes the JAX package's byte path
(`_pair_sums_block_bytes`): the six sums of dosages decoded through
code256 (NaN = missing) are one product of the same stacked planes. The
dosages are not small integers, so the sums are not exact: the JAX package
forms them in float32 (HIGHEST), the port in float64 (on an H100 the
float64 tensor-core GEMM runs at the float32 rate), since float32 sums of
tens of thousands of samples lose r to ~2e-5 on low-variance variants
(port DEVIATIONS #30). r then agrees with float64 to round-off and with
the JAX package's to its float32 error (~1e-5), not bit for bit. On a
DosagePack `finalize="device"` becomes the host finalize, as in the JAX
package (its device finalize assumes integer sums).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
from scipy import stats as scipy_stats

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.ops.blocks import byte_rows, decode_bytes, present_bytes
from bigsnpr_tpu_torch.core.unpack import unpack_codes
from bigsnpr_tpu_torch.utils.assertions import check_args

# decoded operand planes above this many int8 bytes are split over samples
_PLANE_BYTES = 512 << 20


@dataclass
class SparseLD:
    """Sparse symmetric LD matrix, stored upper-triangular CSC (the
    reference's dsCMatrix / SFBM pair, R/corr.R:43-47). `pos` holds the
    scaled positions used for windowing."""

    upper: sp.csc_matrix  # upper triangle incl. diagonal
    pos: np.ndarray | None = None

    @property
    def shape(self):
        return self.upper.shape

    def sym(self) -> sp.csc_matrix:
        """Full symmetric matrix (diagonal counted once)."""
        u = self.upper
        d = sp.diags(u.diagonal())
        return (u + u.T - d).tocsc()

    def col_sums_sq(self, ind_sub=None) -> np.ndarray:
        """Per-column sum of squared entries of the symmetric matrix,
        diagonal counted once (reference src/sp-colsumssq-sym.cpp:9-32,
        src/ld-scores-sfbm.cpp:10-69), from the upper COO triplets."""
        u = self.upper.tocoo()
        i = np.asarray(u.row)
        j = np.asarray(u.col)
        w2 = np.square(np.asarray(u.data, dtype=np.float64))
        m = self.shape[0]
        if ind_sub is not None:
            ind_sub = np.asarray(ind_sub)
            if len(ind_sub) == m and np.array_equal(ind_sub, np.arange(m)):
                ind_sub = None
        if ind_sub is not None:
            posmap = np.full(m, -1, dtype=np.int64)
            posmap[ind_sub] = np.arange(len(ind_sub))
            i = posmap[i]
            j = posmap[j]
            keep = (i >= 0) & (j >= 0)
            i, j, w2 = i[keep], j[keep], w2[keep]
            m = len(ind_sub)
        out = np.bincount(j, w2, minlength=m) + np.bincount(i, w2,
                                                            minlength=m)
        diag = i == j
        if diag.any():
            out -= np.bincount(i[diag], w2[diag], minlength=m)
        return out

    def subset(self, ind) -> "SparseLD":
        ind = np.asarray(ind)
        u = self.sym()[ind][:, ind]
        return SparseLD(upper=sp.triu(u).tocsc(),
                        pos=None if self.pos is None else self.pos[ind])

    def to_dense(self) -> np.ndarray:
        return np.asarray(self.sym().todense())

    def save(self, path) -> str:
        """Persist to .npz, the JAX package's format."""
        import pathlib

        path = pathlib.Path(path)
        if path.suffix != ".npz":
            path = path.with_suffix(".npz")
        u = self.upper
        np.savez_compressed(
            path, data=u.data, indices=u.indices, indptr=u.indptr,
            shape=np.asarray(u.shape),
            pos=(self.pos if self.pos is not None else np.array([])))
        return str(path)

    @staticmethod
    def load(path) -> "SparseLD":
        z = np.load(path)
        upper = sp.csc_matrix(
            (z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
        pos = z["pos"] if len(z["pos"]) else None
        return SparseLD(upper=upper, pos=pos)


# ---------------------------------------------------------------------------
# exact integer pair sums
# ---------------------------------------------------------------------------

def _planes(packed: torch.Tensor, n: int, b0: int, b1: int, k: int):
    """Bytes [b0, b1) of (r, nb) packed rows -> int8 (dosage, NA-free mask)
    of width k: the samples of those bytes below n, zero past them (the pad
    samples of a partial last byte and the padding up to k)."""
    s0 = 4 * b0
    s1 = min(n, 4 * b1)
    codes = unpack_codes(packed[:, b0:b1], s1 - s0)
    mask = (codes != 1).to(torch.int8)
    x = (2 - ((codes.to(torch.int8) + 1) >> 1)) * mask
    if k > s1 - s0:
        pad = (0, k - (s1 - s0))
        x = torch.nn.functional.pad(x, pad)
        mask = torch.nn.functional.pad(mask, pad)
    return x, mask


def _int32_exact(n: int, max_product: int) -> bool:
    """True when a sum of n products of at most `max_product` fits int32:
    then int8 operands with int32 accumulation are exact."""
    return max_product * n < 2**31


def _exact_mm(A: torch.Tensor, C: torch.Tensor, use_int: bool):
    """A (a, k) int8 @ C (c, k)^T, exact: int32 accumulation through
    `torch._int_mm` (rows padded past 16 and to multiples of 8, as it
    requires) or a float64 product. Returns (a, c) int64."""
    if not use_int:
        return (A.double() @ C.double().T).round().long()
    a, c = A.shape[0], C.shape[0]
    ap = max(24, -(-a // 8) * 8)
    cp = -(-c // 8) * 8
    if ap > a:
        A = torch.nn.functional.pad(A, (0, 0, 0, ap - a))
    if cp > c:
        C = torch.nn.functional.pad(C, (0, 0, 0, cp - c))
    return torch._int_mm(A, C.T)[:a, :c].long()


def _chunks(n: int, rows: int):
    """Byte ranges of the packed axis and the padded sample width of each,
    so one chunk's int8 planes stay under _PLANE_BYTES."""
    nb = (n + 3) // 4
    step = max(2, (_PLANE_BYTES // max(1, 3 * rows * 4)) // 2 * 2)
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        yield b0, b1, -(-(min(n, 4 * b1) - 4 * b0) // 8) * 8


def _pair_sums_nona_compact(packed_t, packed_b, n):
    """NA-free pair sums, compact form: (Sxy (B, Wb), st (B,), sst (B,),
    sb (Wb,), ssb (Wb,)) as int64 — one product plane; per-variant sums
    replace the pairwise-complete planes (Np = n)."""
    B, Wb = packed_t.shape[0], packed_b.shape[0]
    use_int = _int32_exact(n, 4)
    dev = packed_t.device
    G = torch.zeros((B, Wb), dtype=torch.int64, device=dev)
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    sst = torch.zeros_like(st)
    sb = torch.zeros(Wb, dtype=torch.int64, device=dev)
    ssb = torch.zeros_like(sb)
    for b0, b1, k in _chunks(n, B + Wb):
        xt, _ = _planes(packed_t, n, b0, b1, k)
        xb, _ = _planes(packed_b, n, b0, b1, k)
        G += _exact_mm(xt, xb, use_int)
        xt, xb = xt.long(), xb.long()
        st += xt.sum(1)
        sst += (xt * xt).sum(1)
        sb += xb.sum(1)
        ssb += (xb * xb).sum(1)
    return G, st, sst, sb, ssb


def _pair_sums_block(packed_t, packed_b, n, nona=False):
    """Targets (B, nb) x band (Wb, nb) packed rows -> the six (B, Wb)
    NA-aware pair sums (Sxy, Sx, Sy, Sxx, Syy, Npair) as int64, where e.g.
    Sx sums x over the samples where both variants are non-missing.

    nona=True (caller-verified NA-free pack) takes the one-plane product
    and broadcasts the per-variant sums; the integers are identical."""
    B, Wb = packed_t.shape[0], packed_b.shape[0]
    if nona:
        Sxy, st, sst, sb, ssb = _pair_sums_nona_compact(packed_t, packed_b, n)
        nf = torch.full((B, Wb), n, dtype=torch.int64, device=Sxy.device)
        return (Sxy, st[:, None].expand(B, Wb), sb[None, :].expand(B, Wb),
                sst[:, None].expand(B, Wb), ssb[None, :].expand(B, Wb), nf)
    use_int = _int32_exact(n, 16)
    G = torch.zeros((3 * B, 3 * Wb), dtype=torch.int64,
                    device=packed_t.device)
    for b0, b1, k in _chunks(n, B + Wb):
        xt, mt = _planes(packed_t, n, b0, b1, k)
        xb, mb = _planes(packed_b, n, b0, b1, k)
        A = torch.cat([xt, xt * xt, mt])
        C = torch.cat([xb, xb * xb, mb])
        G += _exact_mm(A, C, use_int)
    Sxy = G[0:B, 0:Wb]
    Sx = G[0:B, 2 * Wb:3 * Wb]
    Sy = G[2 * B:3 * B, 0:Wb]
    Sxx = G[B:2 * B, 2 * Wb:3 * Wb]
    Syy = G[2 * B:3 * B, Wb:2 * Wb]
    Np = G[2 * B:3 * B, 2 * Wb:3 * Wb]
    return Sxy, Sx, Sy, Sxx, Syy, Np


def _pair_sums_block_bytes(codes_t, codes_b, table):
    """Targets (B, n) x band (Wb, n) byte codes -> the six (B, Wb) NA-aware
    pair sums as float64: the JAX package's stacked product of dosages
    decoded through `table` (float64, NaN = missing), [x; x^2; mask] @
    [y; y^2; mask]^T, summed over chunks of samples (`byte_rows` of the
    B + Wb variants)."""
    B, Wb = codes_t.shape[0], codes_b.shape[0]
    n = codes_t.shape[1]
    G = torch.zeros((3 * B, 3 * Wb), dtype=torch.float64,
                    device=codes_t.device)
    step = byte_rows(B + Wb)
    for s0 in range(0, n, step):
        planes = []
        for c in (codes_t, codes_b):
            c = c[:, s0:s0 + step]
            x = decode_bytes(c, table)
            planes.append(torch.cat([x, x * x,
                                     present_bytes(c, table).double()]))
        G.addmm_(planes[0], planes[1].T)
    Sxy = G[0:B, 0:Wb]
    Sx = G[0:B, 2 * Wb:3 * Wb]
    Sy = G[2 * B:3 * B, 0:Wb]
    Sxx = G[B:2 * B, 2 * Wb:3 * Wb]
    Syy = G[2 * B:3 * B, Wb:2 * Wb]
    Np = G[2 * B:3 * B, 2 * Wb:3 * Wb]
    return Sxy, Sx, Sy, Sxx, Syy, Np


def _pack_is_nona(pack, dev_packed, n) -> bool:
    """True when the pack holds no NA code among its n samples (imputed
    data); cached on the pack. NA code 0b01 is found per 2-bit field with
    b & ~(b >> 1) & 0x55; the pad bits of a partial last byte are masked."""
    flag = getattr(pack, "_nona_flag", None)
    if flag is not None:
        return flag
    rem = n % 4
    flag = True
    step = max(1, (64 << 20) // max(1, dev_packed.shape[1]))
    for r0 in range(0, dev_packed.shape[0], step):
        b = dev_packed[r0:r0 + step]
        if rem:
            b = b.clone()
            b[:, -1] &= (1 << (2 * rem)) - 1
        if bool((b & ~(b >> 1) & 0x55).any()):
            flag = False
            break
    try:
        object.__setattr__(pack, "_nona_flag", flag)
    except AttributeError:
        pass
    return flag


def _iter_band_blocks(dev_packed, n, m, left_start, block, nona):
    """Yield (t0, t1, b0, sums) per target block, band rows [b0, t1);
    sums are the six int64 planes on the pack's device."""
    for t0 in range(0, m, block):
        t1 = min(t0 + block, m)
        b0 = int(left_start[t0:t1].min())
        yield t0, t1, b0, _pair_sums_block(dev_packed[t0:t1],
                                           dev_packed[b0:t1], n, nona=nona)


def _iter_band_blocks_bytes(dev_codes, table, m, left_start, block):
    """`_iter_band_blocks` on byte codes: the six float64 planes."""
    for t0 in range(0, m, block):
        t1 = min(t0 + block, m)
        b0 = int(left_start[t0:t1].min())
        yield t0, t1, b0, _pair_sums_block_bytes(dev_codes[t0:t1],
                                                 dev_codes[b0:t1], table)


def band_blocks(sub, dev, left_start, block):
    """The band blocks of a pack on `dev` and whether they come in the
    NA-free form: exact integer sums of a GenoPack, float64 sums of a
    DosagePack (never NA-free)."""
    if hasattr(sub, "code256"):
        table = torch.as_tensor(np.asarray(sub.code256), dtype=torch.float64,
                                device=dev)
        return _iter_band_blocks_bytes(sub.device_codes(dev), table, sub.m,
                                       left_start, block), False
    dev_packed = sub.device_packed(dev)
    nona = _pack_is_nona(sub, dev_packed, sub.n)
    return _iter_band_blocks(dev_packed, sub.n, sub.m, left_start, block,
                             nona), nona


def _pair_r_device(sums):
    """`_pair_r` on the sums' device: the float64 pairwise-complete r, the
    same formula and operation order (may be NaN)."""
    Sxy, Sx, Sy, Sxx, Syy, Np = (s.double() for s in sums)
    num = Sxy - Sx * Sy / Np
    dx = Sxx - Sx * Sx / Np
    dy = Syy - Sy * Sy / Np
    return num / torch.sqrt(dx * dy)


def _in_window(t0, t1, b0, ls_dev):
    """(t1 - t0, t1 - b0) mask of the neighbours i in [left_start[j], j)
    of each target j of a block, on the device of ls_dev."""
    dev = ls_dev.device
    jj0 = torch.arange(t0, t1, device=dev)[:, None]
    jj = torch.arange(b0, t1, device=dev)[None, :]
    return (jj < jj0) & (jj >= ls_dev[t0:t1, None])


def _window_r2(sums, t0, t1, b0, ls_dev, thr_r2):
    """The pairs of one target block inside the window with r^2 > thr_r2,
    as numpy (i, j, r^2), computed on the sums' device so that only the
    kept pairs reach the host; a NaN r is never kept."""
    r = _pair_r_device(sums)
    r2 = r * r
    a, b = torch.nonzero(_in_window(t0, t1, b0, ls_dev) & (r2 > thr_r2),
                         as_tuple=True)
    return ((b + b0).cpu().numpy(), (a + t0).cpu().numpy(),
            r2[a, b].cpu().numpy())


def _pair_r(sums):
    """float64 pairwise-complete Pearson r from the six sums (may be NaN)."""
    Sxy, Sx, Sy, Sxx, Syy, Np = sums
    with np.errstate(divide="ignore", invalid="ignore"):
        num = Sxy - Sx * Sy / Np
        dx = Sxx - Sx * Sx / Np
        dy = Syy - Sy * Sy / Np
        return num / np.sqrt(dx * dy), Np


def _host_sums(sums, nona):
    """The six planes as float64 numpy arrays, in the JAX package's form
    (an NA-free pack ships one plane plus per-variant vectors)."""
    f64 = lambda t: t.cpu().numpy().astype(np.float64)  # noqa: E731
    if nona:
        Sxy, Sx, Sy, Sxx, Syy, Np = sums
        return (f64(Sxy), f64(Sx[:, :1]), f64(Sy[:1, :]), f64(Sxx[:, :1]),
                f64(Syy[:1, :]), np.float64(Np[0, 0].item()))
    return tuple(f64(s) for s in sums)


def _window_geometry(pos, size):
    """left_start[j] = first index i with pos[i] >= pos[j] - size."""
    pos = np.asarray(pos, dtype=np.float64)
    return np.searchsorted(pos, pos - size, side="left")


def cor_thresholds(n, alpha):
    """THR[nona] for nona = 1..n: t-test threshold on |r| at type-I alpha
    (reference R/corr.R:17-23). NaN where df <= 0."""
    df = np.arange(1, n + 1, dtype=np.float64) - 2
    with np.errstate(invalid="ignore"):
        q = scipy_stats.t.isf(alpha / 2, df)
    q[df <= 0] = np.nan
    with np.errstate(invalid="ignore"):
        thr = q / np.sqrt(df + q**2)
    return thr


def _kept_host(sums, nona, t0, t1, b0, left_start, THR, thr_floor, n):
    r, Np = _pair_r(_host_sums(sums, nona))
    jj0 = np.arange(t0, t1)[:, None]    # target (column of the output)
    jj = np.arange(b0, t1)[None, :]     # neighbour (row of the output)
    in_window = (jj < jj0) & (jj >= left_start[jj0])
    nona_cnt = np.clip(np.asarray(Np).astype(np.int64), 1, n)
    with np.errstate(invalid="ignore"):
        pair_thr = np.maximum(THR[nona_cnt - 1], thr_floor)
        keep = in_window & (np.isnan(r) | (np.abs(r) > pair_thr))
    ii, kk = np.nonzero(keep)
    return jj0[ii, 0], jj[0, kk], np.clip(r[ii, kk], -1.0, 1.0)


def _kept_device(sums, t0, t1, b0, ls_dev, THR_dev, thr_floor, n):
    """The same float64 finalize on the device; kept values rounded to
    float32. Returns numpy (j, i, r)."""
    r = _pair_r_device(sums)
    cnt = sums[5].long().clamp(1, n)
    pair_thr = torch.clamp(THR_dev[cnt - 1], min=thr_floor)
    keep = _in_window(t0, t1, b0, ls_dev) & (torch.isnan(r)
                                            | (r.abs() > pair_thr))
    ii, kk = torch.nonzero(keep, as_tuple=True)
    vals = r[ii, kk].clamp(-1.0, 1.0).float()
    return ((ii + t0).cpu().numpy(), (kk + b0).cpu().numpy(),
            vals.cpu().numpy().astype(np.float64))


@check_args()
def snp_cor(pack, ind_row=None, ind_col=None, size: float = 500,
            alpha: float = 1.0, thr_r2: float = 0.0, fill_diag: bool = True,
            infos_pos=None, block: int = 512, finalize: str = "host",
            device=None) -> SparseLD:
    """Windowed sparse correlation matrix (reference snp_cor,
    R/corr.R:95-110).

    size: window in #SNPs if infos_pos is None, else in kb (multiplied by
    1000 internally), the reference's contract.

    finalize: "host" computes r in float64 on the host from the exact
    integer sums (bit-equal to the JAX package); "device" computes the
    same float64 r on the device and ships only the kept pairs, rounded
    to float32. On a DosagePack the sums are float64 products of decoded
    dosages (the JAX package's are float32: r within its ~1e-5 float32
    error of the JAX package's) and "device" becomes "host", as in the
    JAX package."""
    if finalize not in ("host", "device"):
        raise ValueError(f"finalize must be 'host' or 'device', not "
                         f"{finalize!r}")
    if hasattr(pack, "code256"):
        finalize = "host"   # the device finalize assumes integer sums
    dev = config.resolve_device(device)
    sub = pack
    if ind_col is not None or ind_row is not None:
        sub = pack.subset(ind_row=ind_row, ind_col=ind_col, device=dev)
    n, m = sub.n, sub.m

    if infos_pos is None:
        pos = 1000.0 * np.arange(1, m + 1)
    else:
        pos = np.asarray(infos_pos, dtype=np.float64)
        assert len(pos) == m, "infos_pos length mismatch"
        assert np.all(np.diff(pos) >= 0), "positions must be sorted"
    left_start = _window_geometry(pos, size * 1000.0)
    THR = cor_thresholds(n, alpha)
    thr_floor = float(np.sqrt(thr_r2))

    blocks, nona = band_blocks(sub, dev, left_start, block)
    if finalize == "device":
        ls_dev = torch.as_tensor(left_start, device=dev)
        THR_dev = torch.as_tensor(THR, dtype=torch.float64, device=dev)
    cols_i, cols_j, cols_x = [], [], []
    for t0, t1, b0, sums in blocks:
        if finalize == "device":
            j, i, x = _kept_device(sums, t0, t1, b0, ls_dev, THR_dev,
                                   thr_floor, n)
        else:
            j, i, x = _kept_host(sums, nona, t0, t1, b0, left_start, THR,
                                 thr_floor, n)
        if len(x):
            cols_j.append(j)
            cols_i.append(i)
            cols_x.append(x)

    if fill_diag:
        cols_i.append(np.arange(m))
        cols_j.append(np.arange(m))
        cols_x.append(np.ones(m))
    if cols_i:
        i = np.concatenate(cols_i)
        j = np.concatenate(cols_j)
        x = np.concatenate(cols_x)
    else:
        i = j = np.array([], dtype=np.int64)
        x = np.array([])
    upper = sp.csc_matrix((x, (i, j)), shape=(m, m))
    if np.isnan(upper.data).any():
        warnings.warn("NA or NaN values in the resulting correlation matrix.")
    return SparseLD(upper=upper, pos=pos)


bed_cor = snp_cor
