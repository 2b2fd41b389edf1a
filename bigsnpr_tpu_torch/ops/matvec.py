"""Standardized genotype mat-vec / mat-mat pair.

The {center, scale, X·v, Xᵀ·v} contract that SVD/PCA/PRS consume
(reference R/autoSVD.R:205-219; hot loops src/bed-prod-vec.cpp:15-97).
On CUDA the public functions run the fused decode + GEMM kernels K1/K2
(`ops/geno_kernels.py`), which read only the packed bytes; on the CPU
they run the kernels' plain twins. NA -> 0 after centering == built-in
mean imputation (reference src/bed-acc.h:86-115).

A byte-coded `DosagePack` takes the JAX package's byte path
(`_cprod_bytes_blocked` / `_prod_bytes_blocked`), here in torch on the
device: a block of variants (`blocks.byte_rows`: ~256 MB of float32, fewer
where its int64 gather indices would pass 512 MB) is decoded through a
per-variant table of (code256 - center) / scale (NaN codes -> 0;
`blocks.decode_bytes`) into float32 and multiplied with `torch.matmul` (full float32,
no TF32); the decoded matrix is never whole. It runs no hand-written
kernel: the JAX package's byte path is XLA, not Pallas.

Conventions (the reference's G orientation, samples x variants):
  prodVec : X (n x m) @ u (m[, l]) -> (n[, l])
  cprodVec: Xᵀ     @ v (n[, l]) -> (m[, l])
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.ops import geno_kernels
from bigsnpr_tpu_torch.ops.blocks import byte_rows, decode_bytes
from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator, StdOperator


class TorchOperator(GenoOperator):
    """`GenoOperator` on the plain-torch path on any device (the twin of
    the JAX package's `XlaOperator`): the same surface, masking, scale-0
    rule and scheme, with no hand-written kernel. Under "split2" it runs
    the K7 twins (`cprod_split_plain`, `prod_split_plain`), under "int8"
    the K6 twins (`cprod_i8_plain`, `prod_i8_plain`), under "int8m" the K8
    twins on the operator's materialized planes (`cprod_i8m_plain`,
    `prod_i8m_plain`)."""

    def __init__(self, pack, center, scale, ind_row=None, ind_col=None,
                 block=None, device=None, mxu=None, nona=None):
        super().__init__(pack, center, scale, ind_row=ind_row,
                         ind_col=ind_col, device=device, mxu=mxu, nona=nona)
        self.block = block

    def _cprod_full(self, V):
        if self.mxu == "int8m":
            return geno_kernels.cprod_i8m_plain(self.planes, self.n_full, V,
                                                self.center, self.inv)
        if self.mxu == "int8":
            return geno_kernels.cprod_i8_plain(self.packed, self.n_full, V,
                                               self.center, self.inv,
                                               self.nona)
        if self.mxu == "split2":
            return geno_kernels.cprod_split_plain(self.packed, self.n_full,
                                                  V, self.center, self.inv)
        return geno_kernels.cprod_plain(self.packed, self.n_full, V,
                                        self.center, self.inv, self.block)

    def _prod_full(self, U):
        if self.mxu == "int8m":
            return geno_kernels.prod_i8m_plain(self.planes, self.n_full, U,
                                               self.center, self.inv)
        if self.mxu == "int8":
            return geno_kernels.prod_i8_plain(self.packed, self.n_full, U,
                                              self.center, self.inv,
                                              self.nona)
        if self.mxu == "split2":
            return geno_kernels.prod_split_plain(self.packed, self.n_full, U,
                                                 self.center, self.inv)
        return geno_kernels.prod_plain(self.packed, self.n_full, U,
                                       self.center, self.inv, self.block)


def _prep(pack, w, rows, what, center, scale, device):
    """Operand, center and 1/scale as contiguous f32 tensors on the
    device; center and scale are used as given (defaults 0 and 1)."""
    dev = config.resolve_device(device)
    W = torch.as_tensor(np.asarray(w) if not torch.is_tensor(w) else w,
                        dtype=torch.float32, device=dev)
    if W.shape[0] != rows:
        raise ValueError(f"{what}: vector length {W.shape[0]} != {rows}")
    squeeze = W.dim() == 1
    W = (W[:, None] if squeeze else W).contiguous()
    m = pack.m
    c = np.zeros(m) if center is None else np.asarray(center, np.float64)
    s = np.ones(m) if scale is None else np.asarray(scale, np.float64)
    with np.errstate(divide="ignore"):
        inv = 1.0 / s
    return (pack.device_packed(dev), W, squeeze,
            torch.as_tensor(c, dtype=torch.float32, device=dev),
            torch.as_tensor(inv, dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# the byte path (DosagePack)
# ---------------------------------------------------------------------------

def cprod_bytes(codes, table, V, center, scale, block=None):
    """X~^T V on the device of the (m, n) byte codes: V (n, l) ->
    (m, l) float32, block by block."""
    m, n = codes.shape
    block = byte_rows(n, block)
    out = torch.empty((m, V.shape[1]), dtype=torch.float32,
                      device=codes.device)
    for b0 in range(0, m, block):
        X = decode_bytes(codes[b0:b0 + block], table,
                         center[b0:b0 + block], scale[b0:b0 + block])
        torch.matmul(X, V, out=out[b0:b0 + block])
    return out


def prod_bytes(codes, table, U, center, scale, block=None):
    """X~ U on the device of the (m, n) byte codes: U (m, l) -> (n, l)
    float32, accumulated block by block."""
    m, n = codes.shape
    block = byte_rows(n, block)
    acc = torch.zeros((n, U.shape[1]), dtype=torch.float32,
                      device=codes.device)
    for b0 in range(0, m, block):
        X = decode_bytes(codes[b0:b0 + block], table,
                         center[b0:b0 + block], scale[b0:b0 + block])
        acc.addmm_(X.T, U[b0:b0 + block])
    return acc


class DosageOperator(StdOperator):
    """The standardized operator of a DosagePack on the byte path, with
    `StdOperator`'s surface {n, m, cprod, prod, power, power_dev} over
    `cprod_bytes` / `prod_bytes` (the whole pack: no row or column mask).
    center / scale are used as given, as in the JAX package's byte path (a
    scale of 0 gives inf / NaN there too)."""

    def __init__(self, pack, center, scale, device=None, block=None):
        dev = config.resolve_device(device)
        self.device = dev
        self.codes = pack.device_codes(dev)
        self.n_full = self.n = pack.n
        self.m_full = self.m = pack.m
        self.row_idx = self.col_idx = None
        self.block = block
        self.table = torch.as_tensor(np.asarray(pack.code256),
                                     dtype=torch.float32, device=dev)
        self.center = torch.as_tensor(np.asarray(center, np.float64),
                                      dtype=torch.float32, device=dev)
        self.scale = torch.as_tensor(np.asarray(scale, np.float64),
                                     dtype=torch.float32, device=dev)

    def _cprod_full(self, V):
        return cprod_bytes(self.codes, self.table, V, self.center,
                           self.scale, self.block)

    def _prod_full(self, U):
        return prod_bytes(self.codes, self.table, U, self.center,
                          self.scale, self.block)


def _dosage_op(pack, w, rows, what, center, scale, block, device):
    """The byte-path operator of a DosagePack (center 0 and scale 1 by
    default), after checking the operand's length."""
    if len(w) != rows:
        raise ValueError(f"{what}: vector length {len(w)} != {rows}")
    m = pack.m
    c = np.zeros(m) if center is None else np.asarray(center, np.float64)
    s = np.ones(m) if scale is None else np.asarray(scale, np.float64)
    return DosageOperator(pack, c, s, device=device, block=block)


def snp_cprodVec(pack, v, center=None, scale=None, block=None, device=None):
    """X̃ᵀ v: per-variant scaled dot products (reference bed_cprodVec,
    R/bed-mult-vec.R:50-75 / src/bed-prod-vec.cpp:59-97). Returns numpy
    float32 (m,) or (m, l). `block` is accepted for the JAX package's
    signature; the kernels tile for themselves (on a DosagePack it sets
    the byte path's variant block)."""
    if hasattr(pack, "code256"):
        return _dosage_op(pack, v, pack.n, "cprodVec (n_samples)", center,
                          scale, block, device).cprod(v)
    packed, V, squeeze, c, inv = _prep(pack, v, pack.n, "cprodVec (n_samples)",
                                       center, scale, device)
    out = geno_kernels.cprod(packed, pack.n, V, c, inv).cpu().numpy()
    return out[:, 0] if squeeze else out


def snp_prodVec(pack, u, center=None, scale=None, block=None, device=None):
    """X̃ u: per-sample scores (reference bed_prodVec,
    R/bed-mult-vec.R:20-49 / src/bed-prod-vec.cpp:15-51). Returns numpy
    float32 (n,) or (n, l). `block` is accepted for the JAX package's
    signature; the kernels tile for themselves (on a DosagePack it sets
    the byte path's variant block)."""
    if hasattr(pack, "code256"):
        return _dosage_op(pack, u, pack.m, "prodVec (m_variants)", center,
                          scale, block, device).prod(u)
    packed, U, squeeze, c, inv = _prep(pack, u, pack.m, "prodVec (m_variants)",
                                       center, scale, device)
    out = geno_kernels.prod(packed, pack.n, U, c, inv).cpu().numpy()
    return out[:, 0] if squeeze else out


bed_prodVec = snp_prodVec
bed_cprodVec = snp_cprodVec
