"""Fused 2-bit decode + standardized GEMM: the CUDA kernels K1, K2, K7, K6
and K8, their plain-torch twins, and the operator built on them.

Counterpart of `bigsnpr_tpu/ops/pallas_kernels.py` (`pallas_cprod` /
`pallas_prod` and `PallasOperator`), in three schemes
(`config.pallas_mxu`):

  "highest", K1 `cprod`: X~^T V, V (n, l) -> (m, l)
             K2 `prod` : X~ U,   U (m, l) -> (n, l), both on exact bf16
             bit planes against the operand, centred per column, split
             into three bf16 terms (all 24 bits of its mantissa), float32
             accumulation
  "split2",  K7 `cprod_split` / `prod_split`: the same products on exact
             bf16 bit planes against the operand split into bf16 hi + lo,
             with float32 accumulation (`_cprod_kernel_split`,
             `_prod_kernel_split`)
  "int8",    K6 `cprod_i8` / `prod_i8`: the same products on exact int8
             bit planes with int32 accumulation (`_pallas_cprod_i8`,
             `_pallas_prod_i8`), NA-aware or, for NA-free packs, `_nona`
  "int8m",   K8 `cprod_i8m` / `prod_i8m`: K6's products on int8 planes
             materialized once (`int8m_planes`; `_pallas_cprod_i8m`,
             `_pallas_prod_i8m`), reached only by an operator built with
             mxu="int8m", as in the JAX package

with X~[i, j] = (d_ij - center_j) * inv_j for sample i of variant j, the
dosage d = 2 - ((g + 1) >> 1) of 2-bit code g, and NA (g == 1) -> 0.

The kernels live in `csrc/geno_split.cu` (K1, K2 and K7: one template,
`plane_wgmma_kernel<PROD, TERMS, BNC>`) and `csrc/geno_i8.cu` (K6 and
K8), built with nvcc at first use
(keyed by the source's hash) into `_build/` and loaded with ctypes by
`ops/cuda_build.py`. Each
wrapper launches its kernel for CUDA tensors and counts the launch in
`launches`; for CPU tensors it runs the plain twin. There is no fallback
from a CUDA tensor to the twin.

Unlike the TPU kernels, these work in true sample order on the unpadded
pack: the kernels mask the ragged edges themselves.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.unpack import codes_to_dosage, unpack_codes
from bigsnpr_tpu_torch.ops import cuda_build
from bigsnpr_tpu_torch.ops.blocks import pick_block
from bigsnpr_tpu_torch.ops.corr import _pack_is_nona

I8_SOURCE = cuda_build.PKG / "csrc" / "geno_i8.cu"
SPLIT_SOURCE = cuda_build.PKG / "csrc" / "geno_split.cu"
# the int8 and bit-plane epilogues round as the twins' separate torch ops do
I8_FLAGS = ("--fmad=false",)
SPLIT_FLAGS = ("--fmad=false",)

NPLANES = 4             # radix-128 int8 digits of the float operand
# a raw int32 sum is at most 254 x (contraction length) in absolute value
MAX_I8_DEPTH = 8_000_000
_I8_BK = 128            # the kernel's depth tile: digit rows are padded to it
_PLANE_SUB = 64         # K1 / K2 / K7: operand sub-tile depth, operands padded
# K1 / K2: the deepest run of the depth whose count column's f32 plane sums
# (at most 2 x the run) stay exact integers, below 2^24
MAX_COUNT_DEPTH = 1 << 23

# kernel launches made by the wrappers, by kernel
launches = {"cprod": 0, "prod": 0, "cprod_split": 0, "prod_split": 0,
            "cprod_i8": 0, "cprod_i8_nona": 0, "prod_i8": 0, "prod_i8_nona": 0,
            "cprod_i8m": 0, "cprod_i8m_nona": 0, "prod_i8m": 0,
            "prod_i8m_nona": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build_i8(verbose: bool = False):
    """Compile `csrc/geno_i8.cu` (K6, K8) at first use; returns its path."""
    return cuda_build.build(I8_SOURCE, verbose=verbose, extra=I8_FLAGS)


def build_split(verbose: bool = False):
    """Compile `csrc/geno_split.cu` (K1, K2, K7) at first use; returns its
    path."""
    return cuda_build.build(SPLIT_SOURCE, verbose=verbose, extra=SPLIT_FLAGS)


def _bind_i8(lib):
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.geno_i8_gemm.argtypes = [i32, i32, i32, ptr, i64, ptr, ptr, i64, i64,
                                 i64, ptr, ptr, i64, i64, ptr, i32, i32, i32,
                                 i32, i32, i32, ptr]
    lib.geno_i8_gemm.restype = i32
    lib.geno_i8_epilogue.argtypes = [i32, i32, ptr, i64, i64, ptr, ptr, ptr,
                                     ptr, ptr, ptr, ptr]
    lib.geno_i8_epilogue.restype = i32


def _load_i8():
    return cuda_build.load(I8_SOURCE, _bind_i8, extra=I8_FLAGS)


def _bind_split(lib):
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.geno_plane_prep.argtypes = [i32, i32, ptr, i64, i64, i64, i32, i64,
                                    ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.geno_plane_prep.restype = i32
    lib.geno_plane_gemm.argtypes = [i32, i32, ptr, i64, i64, i64, ptr, i64,
                                    i64, i64, ptr, ptr, ptr, ptr, ptr, ptr,
                                    i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.geno_plane_gemm.restype = i32
    lib.geno_plane_epilogue.argtypes = [i32, i32, ptr, i32, i64, i64, ptr,
                                        ptr, ptr, ptr, ptr, ptr]
    lib.geno_plane_epilogue.restype = i32


def _load_split():
    return cuda_build.load(SPLIT_SOURCE, _bind_split, extra=SPLIT_FLAGS)


# ---------------------------------------------------------------------------
# plain twins (CPU tests; the reference the kernels are held to on the card)
# ---------------------------------------------------------------------------

def standardized(packed: torch.Tensor, n: int, center: torch.Tensor,
                 inv: torch.Tensor) -> torch.Tensor:
    """(k, nb) packed -> (k, n) f32 (d - center) * inv, NA -> 0."""
    d, na = codes_to_dosage(unpack_codes(packed, n))
    x = (d - center[:, None]) * inv[:, None]
    return x.masked_fill(na, 0.0)


def cprod_plain(packed, n, V, center, inv, block=None):
    """K1's function in torch ops: decode a variant block, f32 matmul (the
    direct product, as the JAX package's HIGHEST kernel computes it; the
    kernel reaches it through the plane algebra)."""
    m = packed.shape[0]
    block = block or pick_block(n)
    out = torch.empty((m, V.shape[1]), dtype=torch.float32,
                      device=packed.device)
    for j0 in range(0, m, block):
        j1 = min(m, j0 + block)
        out[j0:j1] = standardized(packed[j0:j1], n, center[j0:j1],
                                  inv[j0:j1]) @ V
    return out


def prod_plain(packed, n, U, center, inv, block=None):
    """K2's function in torch ops: decode a variant block, f32 matmul,
    accumulated over variant blocks (the direct product, which the kernel
    reaches through the plane algebra)."""
    m = packed.shape[0]
    block = block or pick_block(n)
    out = torch.zeros((n, U.shape[1]), dtype=torch.float32,
                      device=packed.device)
    for j0 in range(0, m, block):
        j1 = min(m, j0 + block)
        out += standardized(packed[j0:j1], n, center[j0:j1],
                            inv[j0:j1]).T @ U[j0:j1]
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_SM_COUNT: dict = {}


def _sm_count(dev) -> int:
    """The device's SM count, queried once a device."""
    key = torch.device(dev).index
    if key is None:
        key = torch.cuda.current_device()
    if key not in _SM_COUNT:
        _SM_COUNT[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _SM_COUNT[key]


def _check_operands(src, W, w_rows, center, inv, more=()):
    """The float operand (w_rows, l), center and inv (m,) of a product on
    `src` (m rows): types, shapes, one device, contiguous."""
    m = src.shape[0]
    if W.dtype != torch.float32 or W.dim() != 2 or W.shape[0] != w_rows:
        raise ValueError(f"operand must be float32 ({w_rows}, l), got "
                         f"{W.dtype} {tuple(W.shape)}")
    for name, t in (("center", center), ("inv", inv)):
        if t.dtype != torch.float32 or tuple(t.shape) != (m,):
            raise ValueError(f"{name} must be float32 ({m},)")
    for t in (src, W, center, inv, *more):
        if t.device != src.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src.device}")


def _check(packed, n, W, w_rows, center, inv):
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError("packed must be a 2-D uint8 tensor")
    nb = packed.shape[1]
    if nb != (n + 3) // 4:
        raise ValueError(f"packed has {nb} bytes per variant, n={n} needs "
                         f"{(n + 3) // 4}")
    _check_operands(packed, W, w_rows, center, inv)


def cprod(packed, n, V, center, inv, splits=None):
    """K1: (m, nb) uint8 packed, V (n, l) f32, center/inv (m,) f32 ->
    (m, l) f32 = X~^T V. CUDA tensors launch the bit-plane kernel on Vᵀ,
    centred, split into three bf16 terms (`plane_wgmma_kernel<false, 3,
    BN>`); CPU tensors take `cprod_plain`. `splits` overrides the planned
    depth splits of the GEMM."""
    _check(packed, n, V, n, center, inv)
    if packed.device.type == "cpu":
        return cprod_plain(packed, n, V, center, inv)
    return _launch_plane(False, 3, packed, n, V, center, inv, splits)


def prod(packed, n, U, center, inv, splits=None):
    """K2: U (m, l) f32 -> (n, l) f32 = X~ U. CUDA tensors launch the
    bit-plane kernel on the operand split into three bf16 terms
    (`plane_wgmma_kernel<true, 3, BN>`); CPU tensors take `prod_plain`.
    `splits` overrides the planned depth splits of the GEMM."""
    _check(packed, n, U, packed.shape[0], center, inv)
    if packed.device.type == "cpu":
        return prod_plain(packed, n, U, center, inv)
    return _launch_plane(True, 3, packed, n, U, center, inv, splits)


# ---------------------------------------------------------------------------
# K1, K2 and K7: exact bf16 bit planes against the operand split into bf16
# terms ("highest": three terms, centred; "split2": hi + lo)
# ---------------------------------------------------------------------------

def split_bf16(x: torch.Tensor, terms: int = 2):
    """x f32 -> `terms` bf16 tensors whose sum is ~x: hi = bf16(x), then
    the bf16 of what is left, the subtractions in f32 and every cast round
    to nearest even. Two terms (hi, lo) are `_split_bf16` op for op, so the
    two are bit-equal to the JAX package's; three (hi, mid, lo) hold all 24
    bits of x's mantissa (K1's and K2's operands)."""
    out = []
    r = x
    for t in range(terms):
        b = r.to(torch.bfloat16)
        out.append(b)
        if t + 1 < terms:
            r = r - b.to(torch.float32)
    return tuple(out)


def _bf16_shift(x0, entries):
    """A column's centring constant: its float64 mean x0 rounded to bf16,
    or 0 where |x0| is below 2^-10 of the mean |entry| of `entries` (l,
    depth) (`csrc/geno_split.cu` says why)."""
    depth = entries.shape[1]
    keep = x0.abs() * (1024.0 * depth) >= entries.double().abs().sum(1)
    return torch.where(keep, x0.float().to(torch.bfloat16).float(),
                       torch.zeros_like(x0, dtype=torch.float32))


def _count_row(like):
    """The three-term operand's count row: one bf16 row of ones (1, depth)
    below its term blocks, whose plane sums are T and N."""
    return torch.ones((1, like.shape[1]), dtype=torch.bfloat16,
                      device=like.device)


def _cprod_split_operands(V, center, inv, terms=2):
    """Host-side parts of the bit-plane cprod's twin: Vᵀ split into
    `terms` bf16 row blocks stacked (terms * l, n), its row sums, and
    A = (2 - c) * inv; for three terms (K1) Vᵀ - gamma before the split,
    gamma the mean of each column of V (`_bf16_shift`), a count row of
    ones below the blocks, and the sums and A in float64 (A exact there,
    `csrc/geno_split.cu` says why). Returns (terms, sums, A, shift =
    (gamma, gamma) or None)."""
    Qt = V.T.contiguous()
    if terms != 3:
        return (torch.cat(split_bf16(Qt, terms)), Qt.sum(dim=1),
                (2.0 - center) * inv, None)
    sumv = Qt.double().sum(dim=1)
    gamma = _bf16_shift(sumv / Qt.shape[1], Qt)
    return (torch.cat(split_bf16(Qt - gamma[:, None], 3) + (_count_row(Qt),)),
            sumv, (2.0 - center.double()) * inv.double(), (gamma, gamma))


def _plane_shift(zB, zA, center):
    """K2's centring constants: per column of zB, zA (l, m), alpha = the
    mean of zB weighted by E t = 2 - c and beta = the mean of zA
    (`_bf16_shift`); with the float64 sums of zA. Returns (sumv (l,) f64,
    alpha (l,) f32, beta (l,) f32)."""
    depth = zA.shape[1]
    sumv = zA.double().sum(dim=1)
    w = (2.0 - center).double().sum()
    a0 = sumv / w if float(w) > 0 else torch.zeros_like(sumv)
    return sumv, _bf16_shift(a0, zB), _bf16_shift(sumv / depth, zA)


def _prod_split_operands(U, center, inv, terms=2):
    """Host-side parts of the bit-plane prod's twin: zB = Uᵀ inv and
    zA = Uᵀ A, each split into `terms` stacked bf16 row blocks
    (terms * l, m) after the scaling (as `_prod_kernel_split` splits
    them), the row sums of zA, and, for three terms (K2), the centring
    (alpha, beta) taken off zB and zA before the split, with a count row
    of ones below each block (`_plane_shift`; the sums then float64).
    Returns (zB terms, zA terms, sums, shift or None)."""
    Zt = U.T
    zA = Zt * ((2.0 - center) * inv)[None, :]
    zB = Zt * inv[None, :]
    if terms != 3:
        return (torch.cat(split_bf16(zB.contiguous(), terms)),
                torch.cat(split_bf16(zA.contiguous(), terms)), zA.sum(dim=1),
                None)
    sumv, alpha, beta = _plane_shift(zB, zA, center)
    ones = _count_row(zB)
    return (torch.cat(split_bf16((zB - alpha[:, None]).contiguous(), 3)
                      + (ones,)),
            torch.cat(split_bf16((zA - beta[:, None]).contiguous(), 3)
                      + (ones,)), sumv, (alpha, beta))


def _split_raw_plain(packed, n, ops, prod, block=None, run=None):
    """The raw sums of the bit-plane products in torch ops: (S, 2, R, N)
    float32 for the planes [T, NA] of S depth runs of at most `run` (all of
    it when None), R = m (cprod) or n (prod), N the operand's stacked term
    rows. The planes' values {0, 1, 2} and the bf16 operand are exact in
    float32, so each product is exact and only the float32 accumulation
    rounds; prod accumulates over variant blocks. cprod gives one operand
    for both planes, prod one a plane. A run of at most 2^23 keeps the
    three-term count rows' sums exact integers (`MAX_COUNT_DEPTH`)."""
    m = packed.shape[0]
    block = block or pick_block(n)
    N = ops[0].shape[0]
    dev = packed.device
    W = [o.to(torch.float32) for o in ops]
    K = m if prod else n
    run = run or K
    runs = [(k0, min(K, k0 + run)) for k0 in range(0, K, run)]
    acc = torch.zeros((len(runs), 2, n if prod else m, N),
                      dtype=torch.float32, device=dev)
    for j0 in range(0, m, block):
        j1 = min(m, j0 + block)
        for p, x in enumerate(int_planes(packed[j0:j1], n)):
            x = x.to(torch.float32)
            w = W[min(p, len(W) - 1)]
            for r, (k0, k1) in enumerate(runs):
                if prod:
                    a, b = max(j0, k0), min(j1, k1)
                    if a < b:
                        acc[r, p] += x[a - j0:b - j0].T @ w[:, a:b].T
                else:
                    acc[r, p, j0:j1] = x[:, k0:k1] @ w[:, k0:k1].T
    return acc


def _split_epilogue_plain(raw, l, sumv, A=None, s=None, terms=2,
                          shift=None):
    """raw (S, 2, R, terms * l [+ 1]) of S depth runs -> (R, l) f32: pt =
    the T plane's sums of the terms added in order (hi + lo, or (hi + mid)
    + lo), then over the runs in order, pna the NA plane's; cprod (A, s
    given) (sum - pna) * A - pt * s, prod (sum - pna) - pt (the JAX
    kernels' epilogue). Three terms (shift = (alpha, beta) given, raw's
    last column the count rows' sums T, N, added over the runs in
    float64, where they stay exact past 2^24), in float64: K2 (prod)
    ((sum - alpha T) - beta N) - pna - pt, K1 (cprod) (((sum - beta N) A
    - (alpha T) s) - pna A) - pt s, the kernel's order
    (`csrc/geno_split.cu`)."""
    def add(r):
        out = r[:, :l]
        for t in range(1, terms):
            out = out + r[:, t * l:(t + 1) * l]
        return out

    pt, pna = add(raw[0, 0]), add(raw[0, 1])
    for r in raw[1:]:
        pt, pna = pt + add(r[0]), pna + add(r[1])
    if shift is not None:
        T = raw[:, 0, :, terms * l].double().sum(0)[:, None]
        N = raw[:, 1, :, terms * l].double().sum(0)[:, None]
        alpha, beta = (x.double()[None, :] for x in shift)
        if A is None:
            return ((((sumv[None, :] - alpha * T) - beta * N) - pna.double())
                    - pt.double()).float()
        Ad, sd = A.double()[:, None], s.double()[:, None]
        return (((((sumv[None, :] - beta * N) * Ad) - (alpha * T) * sd)
                 - pna.double() * Ad) - pt.double() * sd).float()
    if A is None:
        return (sumv[None, :] - pna) - pt
    return (sumv[None, :] - pna) * A[:, None] - pt * s[:, None]


def cprod_split_plain(packed, n, V, center, inv, terms=2):
    """K7 cprod's function in torch ops: the same bf16 operand, exact
    products accumulated in float32, and the same epilogue as the
    kernel. `terms=3` is the centred three-term plane algebra that K1
    runs, over depth runs of at most MAX_COUNT_DEPTH samples."""
    qs, qsum, A, shift = _cprod_split_operands(V, center, inv, terms)
    raw = _split_raw_plain(packed, n, [qs], prod=False,
                           run=MAX_COUNT_DEPTH if terms == 3 else None)
    return _split_epilogue_plain(raw, V.shape[1], qsum, A, inv, terms,
                                 shift)


def prod_split_plain(packed, n, U, center, inv, terms=2):
    """K7 prod's function in torch ops (see `cprod_split_plain`); with
    `terms=3`, the centred plane algebra that K2 runs, over depth runs of
    at most MAX_COUNT_DEPTH variants."""
    zbs, zas, zsum, shift = _prod_split_operands(U, center, inv, terms)
    raw = _split_raw_plain(packed, n, [zbs, zas], prod=True,
                           run=MAX_COUNT_DEPTH if terms == 3 else None)
    return _split_epilogue_plain(raw, U.shape[1], zsum, terms=terms,
                                 shift=shift)


# The launch plan of the bit-plane GEMM (`csrc/geno_split.cu` checks it):
# the compiled column tiles by number of terms; a tile's terms are stacked
# as wgmma columns, terms x tile <= 96 (with the f32 sums of 2 planes, what
# a thread's registers hold; `gen_wgmma_bf16.py` writes the widths)
PLANE_BNC = {2: (8, 16, 24, 32, 40), 3: (8, 16, 24, 32)}
PLANE_MAX_STAGES = 8
_PLANE_BM = 128         # rows of a work item: two 64-row warpgroups
_PLANE_HEAD = 2048      # barriers and alignment slack
_PLANE_MAX_SPLITS = 16
_PLANE_MIN_STAGES = 2   # the deepest stage that leaves this many in flight


def _plane_stage_bytes(prod, terms, bn, ksub):
    """Shared memory of one ring stage of `ksub` 64-deep sub-tiles: the
    operand (terms x bn rows of 128 bytes a sub-tile, one a plane in prod)
    and the pack rows (cprod the item's 128 variants, 16 ksub bytes each,
    in rows of 16 (ksub + 1) bytes, at least 48; prod 64 ksub variants
    in rows of 48 bytes), as `csrc/geno_split.cu` lays them out."""
    rows = _PLANE_SUB * ksub if prod else _PLANE_BM
    raw = 48 if prod or ksub < 2 else 16 * (ksub + 1)
    return (2 if prod else 1) * ksub * terms * bn * 128 + rows * raw


def plane_ring(prod, terms, bn, ksub, K):
    """The ring of stages of `ksub` 64-deep sub-tiles for column tiles of
    `bn` and depth K: stages (as many as shared memory holds, at most
    PLANE_MAX_STAGES), ktiles (stages of depth) and smem (bytes)."""
    stage = _plane_stage_bytes(prod, terms, bn, ksub)
    stages = min(PLANE_MAX_STAGES, (I8_SMEM - _PLANE_HEAD) // stage)
    return {"ksub": ksub, "stages": stages,
            "ktiles": -(-K // (_PLANE_SUB * ksub)),
            "smem": _PLANE_HEAD + stages * stage}


def plane_plan(prod, terms, m, n, l, sms, splits=None):
    """The launch plan of the bit-plane GEMM for rows M (cprod m, prod n),
    depth K (cprod n, prod m) and the operand's l columns: column tiles of
    `bn` operand rows, `cols` of them l's (three terms keep the last for
    the count column: bn - 1); n_tiles = ceil(l / the widest tile's cols), and `bn`
    the least compiled width for `terms` whose cols hold ceil(l /
    n_tiles) (a wgmma then spans terms x bn columns); l_pad = bn * n_tiles
    operand rows a term; 128-row M tiles; ring stages of `ksub` 64-deep
    sub-tiles, the deepest of 4, 2, 1 that leaves at least 2 stages in
    shared memory (deep stages beat many: on an H100 a stage costs a fixed
    share of ring traffic), and as many stages as it holds (`plane_ring`);
    a persistent grid of at most one CTA an SM; and the depth in `splits`
    runs of `kps` stages. Unless `splits` is given, the depth is split
    only when the tiles fill the last wave of CTAs to less than 90%, at
    most `_PLANE_MAX_SPLITS` times; a split run writes its raw sums as a
    slice that the epilogue kernel adds in order. Three terms split a
    depth past MAX_COUNT_DEPTH into at least ceil(K / 2^23) runs of at
    most 2^23 each, whatever the cap (the count column's sums stay exact
    in a run; the epilogue adds them over the runs in float64); an explicit
    `splits` that leaves a deeper run raises ValueError."""
    widths = PLANE_BNC[terms]
    ones = 1 if terms == 3 else 0
    n_tiles = -(-l // (widths[-1] - ones))
    bn = min(w for w in widths if w - ones >= -(-l // n_tiles))
    M, K = (n, m) if prod else (m, n)
    m_tiles = -(-M // _PLANE_BM)
    tiles = m_tiles * n_tiles
    for ksub in (4, 2, 1):
        ring = plane_ring(prod, terms, bn, ksub, K)
        if ring["stages"] >= _PLANE_MIN_STAGES:
            break
    ktiles = ring["ktiles"]
    # three terms: a run deeper than MAX_COUNT_DEPTH loses its counts
    max_kps = (MAX_COUNT_DEPTH // (_PLANE_SUB * ring["ksub"]) if terms == 3
               else ktiles)
    least = -(-ktiles // max_kps)
    if splits is None:
        cap = max(least, min(ktiles, _PLANE_MAX_SPLITS))
        splits = least
        while splits < cap:
            items = tiles * splits
            if items >= 0.9 * -(-items // sms) * sms:
                break
            splits += 1
    kps = -(-ktiles // max(1, min(splits, ktiles)))
    if kps > max_kps:
        raise ValueError(
            f"plane_plan: {splits} depth split(s) of a depth of {K} leave a "
            f"run of {kps * _PLANE_SUB * ring['ksub']}, past the three-term "
            f"limit of MAX_COUNT_DEPTH = 2^23 a run; give at least {least}")
    splits = -(-ktiles // kps)
    return {**ring, "bn": bn, "cols": bn - ones, "n_tiles": n_tiles,
            "l_pad": bn * n_tiles, "m_tiles": m_tiles,
            "grid": min(tiles * splits, sms), "splits": splits, "kps": kps}


def _plane_operands(prod, terms, W, center, inv, plan):
    """The bit-plane GEMM's operand (planes, terms, l_pad, ldk) bf16 in
    the kernel's depth order and its sums, made on the card by
    `geno_plane_prep` from W (depth, l): cprod V, prod U (scaled there
    into zB and zA); three terms centre them and add the count rows. The
    sums are (sumv (l,) f64, shift (2, l) f32: three terms' alpha and
    beta, else 0).
    Returns (operand, sums, rc)."""
    lib = _load_split()
    depth, l = W.shape
    dev = W.device
    ldk = -(-depth // _PLANE_SUB) * _PLANE_SUB
    op = torch.empty((2 if prod else 1, terms, plan["l_pad"], ldk),
                     dtype=torch.bfloat16, device=dev)
    partial = torch.empty((4, l, ldk // _PLANE_SUB), dtype=torch.float64,
                          device=dev)
    sumv = torch.empty(l, dtype=torch.float64, device=dev)
    shift = torch.empty((2, l), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.geno_plane_prep(int(prod), terms, W.data_ptr(), depth, l,
                             plan["l_pad"], plan["bn"], ldk,
                             center.data_ptr(), inv.data_ptr(), op.data_ptr(),
                             partial.data_ptr(), sumv.data_ptr(),
                             shift.data_ptr(), stream)
    return op, (sumv, shift), rc


def _plane_gemm(prod, terms, packed, n, op, sums, l, center, inv, plan):
    """The bit-plane GEMM on a prepared operand and its sums, with its
    fused epilogue or, when the plan splits the depth, the epilogue kernel
    that adds the splits in order. Returns (out (R, l) f32, rc)."""
    lib = _load_split()
    m, nb = packed.shape
    dev = packed.device
    R = n if prod else m
    sumv, shift = sums
    out = torch.empty((R, l), dtype=torch.float32, device=dev)
    lr = l + plan["bn"] - plan["cols"]       # three terms: the count too
    raw = (torch.empty((plan["splits"], 2, R, lr), dtype=torch.float32,
                       device=dev) if plan["splits"] > 1 else out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.geno_plane_gemm(
        int(prod), terms, packed.data_ptr(), m, nb, n, op.data_ptr(),
        op.shape[-1], l, plan["l_pad"], center.data_ptr(), inv.data_ptr(),
        sumv.data_ptr(), shift.data_ptr(), out.data_ptr(), raw.data_ptr(),
        plan["bn"], plan["n_tiles"], plan["ksub"], plan["stages"],
        plan["grid"], plan["kps"], plan["splits"], stream)
    if rc == 0 and plan["splits"] > 1:
        rc = lib.geno_plane_epilogue(int(prod), terms, raw.data_ptr(),
                                     plan["splits"], R, l, sumv.data_ptr(),
                                     shift.data_ptr(), center.data_ptr(),
                                     inv.data_ptr(), out.data_ptr(), stream)
    return out, rc


def _launch_plane(prod, terms, packed, n, W, center, inv, splits=None):
    """Prepare the operand and run the bit-plane GEMM (3 terms: K1 and K2,
    counted as "cprod" and "prod"; 2 terms: K7); returns out (R, l).
    `splits` overrides the plan's."""
    m = packed.shape[0]
    l = W.shape[1]
    dev = packed.device
    R = n if prod else m
    if min(m, n, l) == 0:
        return torch.zeros((R, l), dtype=torch.float32, device=dev)
    plan = plane_plan(prod, terms, m, n, l, _sm_count(dev), splits)
    op, sums, rc = _plane_operands(prod, terms, W, center, inv, plan)
    if rc == 0:
        out, rc = _plane_gemm(prod, terms, packed, n, op, sums, l, center,
                              inv, plan)
    kind = ("prod" if prod else "cprod") + ("" if terms == 3 else "_split")
    if rc != 0:
        why = {-1: "the library refused the plan",
               -2: "the CUDA driver would not encode a TMA tensor map"}.get(
                   rc, f"CUDA error {rc}")
        raise RuntimeError(f"geno {kind} launch failed: {why} ({plan})")
    launches[kind] += 1
    return out


def cprod_split(packed, n, V, center, inv, splits=None):
    """K7 cprod: (m, nb) uint8 packed, V (n, l) f32 -> (m, l) f32 = X~^T V
    on bf16 bit planes (T and NA) against Vᵀ split into bf16 hi + lo.
    CUDA tensors launch the kernel; CPU tensors take `cprod_split_plain`.
    `splits` overrides the planned depth splits of the GEMM."""
    _check(packed, n, V, n, center, inv)
    if packed.device.type == "cpu":
        return cprod_split_plain(packed, n, V, center, inv)
    return _launch_plane(False, 2, packed, n, V, center, inv, splits)


def prod_split(packed, n, U, center, inv, splits=None):
    """K7 prod: U (m, l) f32 -> (n, l) f32 = X~ U on bf16 bit planes (see
    `cprod_split`)."""
    _check(packed, n, U, packed.shape[0], center, inv)
    if packed.device.type == "cpu":
        return prod_split_plain(packed, n, U, center, inv)
    return _launch_plane(True, 2, packed, n, U, center, inv, splits)


# ---------------------------------------------------------------------------
# K6: the "int8" scheme (exact int8 bit planes, int32 accumulation)
# ---------------------------------------------------------------------------

def int8_planes(y: torch.Tensor):
    """y (l, k) f32 -> (NPLANES*l, k) int8 radix-128 digits and the per-row
    scale (l,) f32, with y[r] ~ scale[r] * sum_p digits[p*l+r] / 128**p:
    `_int8_planes` op for op (torch.round is half-to-even, as jnp.round),
    so the digits and scales are bit-equal to the JAX package's."""
    s = y.abs().amax(dim=1, keepdim=True)
    s = torch.where(s > 0, s, torch.ones((), dtype=s.dtype, device=s.device))
    # both divisions by full tensors: torch takes `scalar / t`, and on CUDA
    # `t / scalar`, as a product with a rounded reciprocal
    x = y * (torch.full_like(s, 127.0) / s)
    planes = []
    for _ in range(NPLANES):
        q = torch.round(x)
        planes.append(q.to(torch.int8))
        x = (x - q) * 128.0
    return torch.cat(planes, dim=0), s[:, 0] / torch.full_like(s[:, 0], 127.0)


def int_planes(packed: torch.Tensor, n: int):
    """(k, nb) packed -> (t, na) int8 planes (k, n): t = b1 + (b0 & b1) in
    {0, 1, 2} and na = b0 & ~b1 in {0, 1} of each code's bits b0 (low) and
    b1 (`_decode_int_planes_i8`)."""
    g = unpack_codes(packed, n)
    b0, b1 = g & 1, g >> 1
    u = b0 & b1
    return (b1 + u).to(torch.int8), (b0 - u).to(torch.int8)


def _cprod_i8_operands(V, center, inv):
    """Host-side parts of K6 cprod, shared by kernel and twin: the digits
    and scale of Vᵀ, its row sums, and A = (2 - c) * inv."""
    Qt = V.T.contiguous()
    q8, qscale = int8_planes(Qt)
    return q8, qscale, Qt.sum(dim=1), (2.0 - center) * inv


def _prod_i8_operands(U, center, inv, nona):
    """Host-side parts of K6 prod: digits and scales of zB = Uᵀ inv and
    (with NA) zA = Uᵀ A, and the row sums of zA."""
    Zt = U.T
    zA = Zt * ((2.0 - center) * inv)[None, :]
    zB = Zt * inv[None, :]
    zb8, zbs = int8_planes(zB.contiguous())
    za8, zas = (None, None) if nona else int8_planes(zA.contiguous())
    return zb8, zbs, za8, zas, zA.sum(dim=1)


def _raw_sums(planes_of, m, n, digits, P, prod, device, block):
    """The raw integer sums of K6 and K8 in torch ops: (P, R, 4l) int32
    over the planes [T] or [T, NA] that `planes_of(j0, j1)` gives for
    variants j0..j1, R = m (cprod) or n (prod). The products with the
    digits are taken in float64, exact while |sums| < 2^53, and
    accumulated over variant blocks. cprod gives one digit array for both
    planes; prod one a plane."""
    shape = (P, n if prod else m, digits[0].shape[0])
    acc = torch.zeros(shape, dtype=torch.float64, device=device)
    for j0 in range(0, m, block):
        j1 = min(m, j0 + block)
        planes = planes_of(j0, j1)
        for p in range(P):
            x = planes[p].double()
            d = digits[min(p, len(digits) - 1)]
            if prod:
                acc[p] += x.T @ d[:, j0:j1].double().T
            else:
                acc[p, j0:j1] = x @ d.double().T
    return acc.to(torch.int32)


def _raw_plain(packed, n, digits, nona, prod, block=None):
    """K6's raw sums: the planes decoded from the pack (`int_planes`)."""
    return _raw_sums(lambda j0, j1: int_planes(packed[j0:j1], n),
                     packed.shape[0], n, digits, 1 if nona else 2, prod,
                     packed.device, block or pick_block(n))


def _combine(raw_p, l):
    """(R, 4l) integer digit sums -> (R, l) f32, `_combine_planes`' order:
    ((w0 + w1/128) + w2/128^2) + w3/128^3."""
    parts = raw_p.to(torch.float32).reshape(raw_p.shape[0], NPLANES, l)
    out = parts[:, 0]
    f = 1.0
    for p in range(1, NPLANES):
        f = f / 128.0
        out = out + parts[:, p] * f
    return out


def _epilogue_plain(raw, l, sc_t, sc_na, sumv, A=None, s=None):
    """raw (planes, R, 4l) -> (R, l) f32: cprod (A, s given)
    (sum - pna) * A - pt * s, prod (sum - pna) - pt, with pt = comb_t *
    sc_t and pna = comb_na * sc_na (0 for an NA-free pack)."""
    pt = _combine(raw[0], l) * sc_t[None, :]
    pna = 0.0 if raw.shape[0] == 1 else _combine(raw[1], l) * sc_na[None, :]
    if A is None:
        return (sumv[None, :] - pna) - pt
    return (sumv[None, :] - pna) * A[:, None] - pt * s[:, None]


def _check_i8(packed, n, W, w_rows, center, inv, depth):
    _check(packed, n, W, w_rows, center, inv)
    if depth > MAX_I8_DEPTH:
        raise ValueError(
            f"int8 scheme: contraction length {depth} > {MAX_I8_DEPTH}; the "
            f"int32 sums (at most 254 per term) could overflow")


# The launch plan of the K6 / K8 GEMM (`csrc/geno_i8.cu` checks it):
# the compiled column tiles (N widths of .s8 wgmma)
I8_WIDTHS = (16, 32, 48, 64, 80, 96, 128)
I8_MAX_STAGES = 8       # ring stages in flight (the kernel's most)
I8_SMEM = 232_448       # shared memory a block may have on sm_90
_I8_TILE = 128 * 128    # bytes of a 128 x 128 int8 tile
_I8_HEAD = 2048         # barriers and alignment slack
_I8_MAX_SPLITS = 16


def i8_plan(prod, nona, mat, m, n, l, sms, splits=None):
    """The launch plan of the int8 GEMM for rows M (cprod m, prod n), depth
    K (cprod n, prod m) and N = 4l digit columns: column tiles of `bn`
    (the least compiled width that holds ceil(N / n_tiles), n_tiles =
    ceil(N / 128)); M tiles of `bm` rows (two consumer warpgroups of one
    64-row wgmma tile each, or of two for an NA-free prod, whose items then
    read 256 contiguous bytes of each plane row); as many ring stages as
    shared memory holds (at most I8_MAX_STAGES); a persistent grid of at
    most one CTA an SM; and the depth in `splits` runs of `kps` 128-deep
    tiles. Unless `splits` is given, the depth is split only when the
    tiles fill the last wave of CTAs to less than 90%; a split run adds
    into a zeroed raw buffer (`zero_raw`)."""
    N4 = NPLANES * l
    n_tiles = -(-N4 // 128)
    per = -(-N4 // n_tiles)
    bn = min(w for w in I8_WIDTHS if w >= per)
    msub = 2 if prod and nona else 1
    bm = 128 * msub
    M, K = (n, m) if prod else (m, n)
    m_tiles = -(-M // bm)
    ktiles = -(-K // _I8_BK)
    tiles = m_tiles * n_tiles
    P = 1 if nona else 2
    # K6 stages a packed row's bytes (32 a stage in cprod, bm / 4 in prod)
    # as aligned 16-byte chunks, one more for the row's misalignment
    raw = 16 * ((bm // 4 if prod else 32) // 16 + 1)
    stage = (2 if prod and not nona else 1) * bn * _I8_BK + (
        P * msub * _I8_TILE if mat else 128 * raw)
    # K6 prod transposes into two staging tile sets, K8 prod in place
    fixed = _I8_HEAD + (2 * P * msub * _I8_TILE if prod and not mat else 0)
    stages = min(I8_MAX_STAGES, (I8_SMEM - fixed) // stage)
    if splits is None:
        cap = min(ktiles, _I8_MAX_SPLITS)
        splits = 1
        while splits < cap:
            items = tiles * splits
            if items >= 0.9 * -(-items // sms) * sms:
                break
            splits += 1
    kps = -(-ktiles // max(1, min(splits, ktiles)))
    splits = -(-ktiles // kps)
    return {"bn": bn, "n_tiles": n_tiles, "n_pad": bn * n_tiles,
            "bm": bm, "m_tiles": m_tiles, "stages": stages,
            "grid": min(tiles * splits, sms), "splits": splits, "kps": kps,
            "ktiles": ktiles, "zero_raw": splits > 1,
            "smem": fixed + stages * stage}


def _launch_i8(prod, nona, src, n, digits, R, l, sc_t, sc_na, sumv, A, s,
               splits=None):
    """Run the K6 GEMM (`src` the packed bytes) or the K8 GEMM (`src` the
    planes (T, NA)) into int32 raw sums, then the epilogue kernel; returns
    (out (R, l) f32, raw (planes, R, 4l) int32). `splits` (depth splits of
    the GEMM) defaults to `i8_plan`'s."""
    lib = _load_i8()
    mat = isinstance(src, tuple)
    m = src[0].shape[0] if mat else src.shape[0]
    dev = src[0].device if mat else src.device
    depth = m if prod else n
    ldd = -(-depth // _I8_BK) * _I8_BK
    # the digit arrays, zero-padded to ldd, in one allocation
    dig = torch.zeros((len(digits), digits[0].shape[0], ldd),
                      dtype=torch.int8, device=dev)
    for i, d in enumerate(digits):
        dig[i, :, :depth] = d
    N4 = NPLANES * l
    P = 1 if nona else 2
    plan = i8_plan(prod, nona, mat, m, n, l, _sm_count(dev), splits)
    alloc = torch.zeros if plan["zero_raw"] else torch.empty
    raw = alloc((P, R, N4), dtype=torch.int32, device=dev)
    out = torch.empty((R, l), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mat:
        T, NA = src
        planes = (T.data_ptr(), (T if NA is None else NA).data_ptr(),
                  T.shape[1])
        packed, nb = 0, 0
    else:
        planes = (0, 0, 0)
        packed, nb = src.data_ptr(), src.shape[1]
    rc = lib.geno_i8_gemm(int(prod), int(nona), int(mat), packed, nb,
                          *planes, m, n, dig[0].data_ptr(),
                          dig[-1].data_ptr(), ldd, N4, raw.data_ptr(),
                          plan["bn"], plan["n_tiles"], plan["stages"],
                          plan["grid"], plan["kps"], plan["splits"], stream)
    if rc == 0:
        rc = lib.geno_i8_epilogue(
            int(prod), int(nona), raw.data_ptr(), R, l, sc_t.data_ptr(),
            sc_na.data_ptr(), sumv.data_ptr(),
            0 if A is None else A.data_ptr(),
            0 if s is None else s.data_ptr(), out.data_ptr(), stream)
    kind = (("prod_i8" if prod else "cprod_i8") + ("m" if mat else "")
            + ("_nona" if nona else ""))
    if rc != 0:
        why = {-1: "the library refused the plan",
               -2: "the CUDA driver would not encode a TMA tensor map"}.get(
                   rc, f"CUDA error {rc}")
        raise RuntimeError(f"geno {kind} launch failed: {why} ({plan})")
    launches[kind] += 1
    return out, raw


def cprod_i8_plain(packed, n, V, center, inv, nona=False, return_raw=False):
    """K6 cprod's function in torch ops: the same digits, exact integer
    sums (float64 products), recombination and epilogue as the kernel."""
    q8, qscale, qsum, A = _cprod_i8_operands(V, center, inv)
    raw = _raw_plain(packed, n, [q8], nona, prod=False)
    out = _epilogue_plain(raw, V.shape[1], qscale, qscale, qsum, A, inv)
    return (out, raw) if return_raw else out


def prod_i8_plain(packed, n, U, center, inv, nona=False, return_raw=False):
    """K6 prod's function in torch ops (see `cprod_i8_plain`)."""
    zb8, zbs, za8, zas, zsum = _prod_i8_operands(U, center, inv, nona)
    raw = _raw_plain(packed, n, [zb8] if nona else [zb8, za8], nona,
                     prod=True)
    out = _epilogue_plain(raw, U.shape[1], zbs, zas, zsum)
    return (out, raw) if return_raw else out


def cprod_i8(packed, n, V, center, inv, nona=False, return_raw=False,
             splits=None):
    """K6 cprod: (m, nb) uint8 packed, V (n, l) f32 -> (m, l) f32 = X~^T V
    on int8 bit planes (T, and NA unless `nona`, which the caller asserts:
    an NA code then counts as dosage 2). CUDA tensors launch the kernel;
    CPU tensors take `cprod_i8_plain`. `return_raw` also returns the
    (planes, m, 4l) int32 digit sums; `splits` overrides the planned depth
    splits of the GEMM (the sums do not depend on it)."""
    _check_i8(packed, n, V, n, center, inv, n)
    if packed.device.type == "cpu":
        return cprod_i8_plain(packed, n, V, center, inv, nona, return_raw)
    q8, qscale, qsum, A = _cprod_i8_operands(V, center, inv)
    out, raw = _launch_i8(False, nona, packed, n, [q8], packed.shape[0],
                          V.shape[1], qscale, qscale, qsum, A, inv, splits)
    return (out, raw) if return_raw else out


def prod_i8(packed, n, U, center, inv, nona=False, return_raw=False,
            splits=None):
    """K6 prod: U (m, l) f32 -> (n, l) f32 = X~ U on int8 bit planes (see
    `cprod_i8`)."""
    m = packed.shape[0]
    _check_i8(packed, n, U, m, center, inv, m)
    if packed.device.type == "cpu":
        return prod_i8_plain(packed, n, U, center, inv, nona, return_raw)
    zb8, zbs, za8, zas, zsum = _prod_i8_operands(U, center, inv, nona)
    digits = [zb8] if nona else [zb8, za8]
    out, raw = _launch_i8(True, nona, packed, n, digits, n, U.shape[1], zbs,
                          zbs if nona else zas, zsum, None, None, splits)
    return (out, raw) if return_raw else out


# ---------------------------------------------------------------------------
# K8: the "int8m" scheme (K6's GEMMs on int8 planes materialized once)
# ---------------------------------------------------------------------------

def int8m_planes(packed, n, nona=False, chunk=4096):
    """(m, nb) packed -> (T, NA) int8 planes (m, ldn) in true sample order,
    ldn = n rounded up to 16 bytes, the pad columns zero; NA is None when
    `nona` (an NA code then counts as dosage 2, as in K6's _nona kernels).
    The counterpart of `materialize_int8_planes_chunked`: built `chunk`
    variants at a time into the preallocated planes, so that the peak is
    the planes plus one chunk's decode."""
    m = packed.shape[0]
    ldn = -(-n // 16) * 16
    T = torch.zeros((m, ldn), dtype=torch.int8, device=packed.device)
    NA = None if nona else torch.zeros_like(T)
    for j0 in range(0, m, chunk):
        t, na = int_planes(packed[j0:j0 + chunk], n)
        T[j0:j0 + chunk, :n] = t
        if NA is not None:
            NA[j0:j0 + chunk, :n] = na
    return T, NA


def _raw_i8m_plain(planes, n, digits, prod, block=None):
    """K8's raw sums: the first n columns of the materialized planes."""
    live = [p for p in planes if p is not None]
    return _raw_sums(lambda j0, j1: [p[j0:j1, :n] for p in live],
                     live[0].shape[0], n, digits, len(live), prod,
                     live[0].device, block or pick_block(n))


def _check_i8m(planes, n, W, w_rows, center, inv):
    T, NA = planes
    if T.dtype != torch.int8 or T.dim() != 2:
        raise TypeError("the planes must be 2-D int8 tensors")
    ldn = -(-n // 16) * 16
    if T.shape[1] != ldn:
        raise ValueError(f"planes have {T.shape[1]} columns, n={n} needs "
                         f"{ldn}")
    if NA is not None and (NA.dtype != torch.int8 or NA.shape != T.shape):
        raise ValueError("the NA plane must match the T plane")
    _check_operands(T, W, w_rows, center, inv,
                    () if NA is None else (NA,))
    if T.device.type == "cuda" and any(
            p is not None and p.data_ptr() % 16 for p in planes):
        raise ValueError("the planes must be 16-byte aligned")
    if w_rows > MAX_I8_DEPTH:
        raise ValueError(
            f"int8m scheme: contraction length {w_rows} > {MAX_I8_DEPTH}; "
            f"the int32 sums (at most 254 per term) could overflow")


def cprod_i8m_plain(planes, n, V, center, inv, return_raw=False):
    """K8 cprod's function in torch ops: K6's digits, recombination and
    epilogue (`cprod_i8_plain`) on the materialized planes."""
    q8, qscale, qsum, A = _cprod_i8_operands(V, center, inv)
    raw = _raw_i8m_plain(planes, n, [q8], prod=False)
    out = _epilogue_plain(raw, V.shape[1], qscale, qscale, qsum, A, inv)
    return (out, raw) if return_raw else out


def prod_i8m_plain(planes, n, U, center, inv, return_raw=False):
    """K8 prod's function in torch ops (see `cprod_i8m_plain`)."""
    nona = planes[1] is None
    zb8, zbs, za8, zas, zsum = _prod_i8_operands(U, center, inv, nona)
    raw = _raw_i8m_plain(planes, n, [zb8] if nona else [zb8, za8],
                         prod=True)
    out = _epilogue_plain(raw, U.shape[1], zbs, zas, zsum)
    return (out, raw) if return_raw else out


def cprod_i8m(planes, n, V, center, inv, return_raw=False, splits=None):
    """K8 cprod: planes (T, NA or None) from `int8m_planes`, V (n, l) f32
    -> (m, l) f32 = X~^T V. CUDA tensors launch the kernel; CPU tensors
    take `cprod_i8m_plain`. `return_raw` and `splits` as for `cprod_i8`;
    the raw sums are K6's on the same pack."""
    _check_i8m(planes, n, V, n, center, inv)
    if planes[0].device.type == "cpu":
        return cprod_i8m_plain(planes, n, V, center, inv, return_raw)
    q8, qscale, qsum, A = _cprod_i8_operands(V, center, inv)
    out, raw = _launch_i8(False, planes[1] is None, tuple(planes), n, [q8],
                          planes[0].shape[0], V.shape[1], qscale, qscale,
                          qsum, A, inv, splits)
    return (out, raw) if return_raw else out


def prod_i8m(planes, n, U, center, inv, return_raw=False, splits=None):
    """K8 prod: U (m, l) f32 -> (n, l) f32 = X~ U on the materialized
    planes (see `cprod_i8m`)."""
    _check_i8m(planes, n, U, planes[0].shape[0], center, inv)
    if planes[0].device.type == "cpu":
        return prod_i8m_plain(planes, n, U, center, inv, return_raw)
    nona = planes[1] is None
    zb8, zbs, za8, zas, zsum = _prod_i8_operands(U, center, inv, nona)
    out, raw = _launch_i8(True, nona, tuple(planes), n,
                          [zb8] if nona else [zb8, za8], n, U.shape[1], zbs,
                          zbs if nona else zas, zsum, None, None, splits)
    return (out, raw) if return_raw else out


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

class StdOperator:
    """The surface {n, m, cprod, prod, power, cprod_dev, prod_dev,
    power_dev} of a standardized operator over its full-matrix products
    `_cprod_full` / `_prod_full`. A subclass sets `device`, `n_full`,
    `m_full`, `n`, `m` and the optional row / column subsets `row_idx` /
    `col_idx` (long tensors on the device, or None): inputs are scattered
    to the full matrix and outputs gathered from it on the device."""

    def _as_2d(self, arr):
        t = torch.as_tensor(arr, dtype=torch.float32, device=self.device)
        squeeze = t.dim() == 1
        return (t[:, None] if squeeze else t).contiguous(), squeeze

    def _scatter(self, W, idx, rows):
        if idx is None:
            return W.contiguous()
        full = torch.zeros((rows, W.shape[1]), dtype=torch.float32,
                           device=self.device)
        full[idx] = W
        return full

    @staticmethod
    def _gather(W, idx):
        return W if idx is None else W[idx]

    def cprod_dev(self, V: torch.Tensor) -> torch.Tensor:
        """X~^T V on the device: V (n, l) -> (m, l)."""
        out = self._cprod_full(self._scatter(V, self.row_idx, self.n_full))
        return self._gather(out, self.col_idx)

    def prod_dev(self, U: torch.Tensor) -> torch.Tensor:
        """X~ U on the device: U (m, l) -> (n, l)."""
        out = self._prod_full(self._scatter(U, self.col_idx, self.m_full))
        return self._gather(out, self.row_idx)

    def cprod(self, V):
        """X~^T V: V (n, l) -> (m, l) numpy float32."""
        V, squeeze = self._as_2d(V)
        out = self.cprod_dev(V).cpu().numpy()
        return out[:, 0] if squeeze else out

    def prod(self, U):
        """X~ U: U (m, l) -> (n, l) numpy float32."""
        U, squeeze = self._as_2d(U)
        out = self.prod_dev(U).cpu().numpy()
        return out[:, 0] if squeeze else out

    def power(self, V):
        """One Krylov step, (X~^T V, X~ X~^T V), as numpy arrays."""
        B, Y = self.power_dev(self._as_2d(V)[0])
        return B.cpu().numpy(), Y.cpu().numpy()

    def power_dev(self, V: torch.Tensor):
        """Power step on the device, cprod then prod (on a GenoOperator K1
        then K2, K7, K6 or K8 twice) on one stream with no host round-trip:
        V (n, l) -> (B = X~^T V (m, l), Y = X~ B (n, l))."""
        B = self.cprod_dev(V)
        return B, self.prod_dev(B)


class GenoOperator(StdOperator):
    """Device-resident standardized genotype operator on K1/K2 (scheme
    "highest"), K7 ("split2"), K6 ("int8") or K8 ("int8m"), with the
    surface {n, m, cprod, prod, power, power_dev} of the JAX package's
    `PallasOperator`.

    mxu=None takes `config.pallas_mxu`; "int8m" builds the int8 planes once
    here (`int8m_planes`: n m bytes, twice that with NA, on the device
    beside the pack). Under "int8" and "int8m", nona=None scans the pack
    once for an NA code (the PLINK zero pad of a partial last byte is code
    0, not NA), and an NA-free pack runs the `_nona` kernels. A variant whose
    scale is <= 0 contributes exactly 0 (inv = 0, center = 2). Optional
    ind_row/ind_col make the operator act as the physically subsetted
    matrix would, while the packed bytes stay whole (and cached) on the
    device: inputs are scattered and outputs gathered on the device."""

    def __init__(self, pack, center, scale, ind_row=None, ind_col=None,
                 device=None, mxu=None, nona=None):
        dev = config.resolve_device(device)
        self.device = dev
        self.mxu = config.resolve_mxu(mxu)
        self.packed = pack.device_packed(dev)
        # only the int8 schemes have an NA-free path; the others skip the scan
        self.nona = bool(nona) if nona is not None else (
            self.mxu in ("int8", "int8m")
            and _pack_is_nona(pack, self.packed, pack.n))
        self.planes = (int8m_planes(self.packed, pack.n, self.nona)
                       if self.mxu == "int8m" else None)
        self.n_full, self.m_full = pack.n, pack.m
        center = np.asarray(center, dtype=np.float64)
        scale = np.asarray(scale, dtype=np.float64)
        good = scale > 0
        inv = np.zeros(self.m_full)
        inv[good] = 1.0 / scale[good]
        ctr = np.where(good, center, 2.0)
        self.center = torch.as_tensor(ctr, dtype=torch.float32, device=dev)
        self.inv = torch.as_tensor(inv, dtype=torch.float32, device=dev)
        self.row_idx = self._index(ind_row)
        self.col_idx = self._index(ind_col)
        self.n = self.n_full if ind_row is None else len(ind_row)
        self.m = self.m_full if ind_col is None else len(ind_col)

    def _index(self, idx):
        if idx is None:
            return None
        return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                               device=self.device)

    # full-matrix products; TorchOperator swaps in the plain twins
    def _cprod_full(self, V):
        if self.mxu == "int8m":
            return cprod_i8m(self.planes, self.n_full, V, self.center,
                             self.inv)
        if self.mxu == "int8":
            return cprod_i8(self.packed, self.n_full, V, self.center,
                            self.inv, nona=self.nona)
        if self.mxu == "split2":
            return cprod_split(self.packed, self.n_full, V, self.center,
                               self.inv)
        return cprod(self.packed, self.n_full, V, self.center, self.inv)

    def _prod_full(self, U):
        if self.mxu == "int8m":
            return prod_i8m(self.planes, self.n_full, U, self.center,
                            self.inv)
        if self.mxu == "int8":
            return prod_i8(self.packed, self.n_full, U, self.center,
                           self.inv, nona=self.nona)
        if self.mxu == "split2":
            return prod_split(self.packed, self.n_full, U, self.center,
                              self.inv)
        return prod(self.packed, self.n_full, U, self.center, self.inv)
