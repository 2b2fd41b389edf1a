"""Standardized genotype mat-vec / mat-mat pair.

The {center, scale, X·v, Xᵀ·v} contract that SVD/PCA/PRS consume
(reference R/autoSVD.R:205-219; hot loops src/bed-prod-vec.cpp:15-97).
On CUDA the public functions run the fused decode + GEMM kernels K1/K2
(`ops/geno_kernels.py`), which read only the packed bytes; on the CPU
they run the kernels' plain twins. NA -> 0 after centering == built-in
mean imputation (reference src/bed-acc.h:86-115).

Conventions (the reference's G orientation, samples x variants):
  prodVec : X (n x m) @ u (m[, l]) -> (n[, l])
  cprodVec: Xᵀ     @ v (n[, l]) -> (m[, l])
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.ops import geno_kernels
from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator


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


def snp_cprodVec(pack, v, center=None, scale=None, block=None, device=None):
    """X̃ᵀ v: per-variant scaled dot products (reference bed_cprodVec,
    R/bed-mult-vec.R:50-75 / src/bed-prod-vec.cpp:59-97). Returns numpy
    float32 (m,) or (m, l). `block` is accepted for the JAX package's
    signature; the kernels tile for themselves."""
    if hasattr(pack, "code256"):
        raise NotImplementedError(
            "snp_cprodVec on a DosagePack: ROADMAP slice 6c")
    packed, V, squeeze, c, inv = _prep(pack, v, pack.n, "cprodVec (n_samples)",
                                       center, scale, device)
    out = geno_kernels.cprod(packed, pack.n, V, c, inv).cpu().numpy()
    return out[:, 0] if squeeze else out


def snp_prodVec(pack, u, center=None, scale=None, block=None, device=None):
    """X̃ u: per-sample scores (reference bed_prodVec,
    R/bed-mult-vec.R:20-49 / src/bed-prod-vec.cpp:15-51). Returns numpy
    float32 (n,) or (n, l). `block` is accepted for the JAX package's
    signature; the kernels tile for themselves."""
    if hasattr(pack, "code256"):
        raise NotImplementedError(
            "snp_prodVec on a DosagePack: ROADMAP slice 6c")
    packed, U, squeeze, c, inv = _prep(pack, u, pack.m, "prodVec (m_variants)",
                                       center, scale, device)
    out = geno_kernels.prod(packed, pack.n, U, c, inv).cpu().numpy()
    return out[:, 0] if squeeze else out


bed_prodVec = snp_prodVec
bed_cprodVec = snp_cprodVec
