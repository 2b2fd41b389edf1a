"""Genetic relationship matrix (GRM) / tcrossprod.

Reference: bed_tcrossprodSelf (R/bed-tcrossprodSelf.R:21-52): blocked
X̃ X̃ᵀ with per-block scaling accumulated on disk. The JAX package runs it
as one XLA scan over variant blocks (`_grm_blocked`, not a Pallas
kernel); here each block of variants is decoded and standardized on the
device (`core/unpack.unpack_standardized`) and added into the (n, n)
float32 accumulator, which stays on the device, by one `addmm_` update
at `config.matmul_precision` (`ops/precision.py`: IEEE float32 under
"highest", bf16 tensor-core products under "high" / "default", as the JAX
package's scan reads the option). Monomorphic variants get scale 1, as in
the JAX package (they standardize to 0).
"""

from __future__ import annotations

import numpy as np
import torch

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.unpack import unpack_standardized
from bigsnpr_tpu_torch.linalg.randomsvd import call_scaling
from bigsnpr_tpu_torch.ops import precision
from bigsnpr_tpu_torch.ops.blocks import pick_block
from bigsnpr_tpu_torch.ops.stats import bed_scaleBinom


def grm_blocked(packed: torch.Tensor, n: int, center: torch.Tensor,
                scale: torch.Tensor, block: int) -> torch.Tensor:
    """(n, n) float32 X̃ X̃ᵀ of a (m, nb) packed tensor, accumulated over
    blocks of `block` variants on the pack's device at
    `config.matmul_precision`."""
    prec = precision.resolve()
    acc = torch.zeros((n, n), dtype=torch.float32, device=packed.device)
    for j0 in range(0, packed.shape[0], block):
        j1 = j0 + block
        xt = unpack_standardized(packed[j0:j1], n, center[j0:j1],
                                 scale[j0:j1])           # (block, n)
        precision.addmm_(acc, xt.T, xt, prec)
    return acc


def bed_tcrossprodSelf(pack, fun_scaling=bed_scaleBinom, ind_row=None,
                       ind_col=None, block=None, device=None):
    """(n, n) GRM-style matrix X̃ X̃ᵀ as float64 numpy; returns (K, center,
    scale)."""
    dev = config.resolve_device(device)
    sub = pack
    if ind_row is not None or ind_col is not None:
        sub = pack.subset(ind_row=ind_row, ind_col=ind_col, device=dev)
    sc = call_scaling(fun_scaling, sub, None, dev)
    center = np.asarray(sc["center"], dtype=np.float64)
    scale = np.asarray(sc["scale"], dtype=np.float64)
    safe_scale = np.where(scale > 0, scale, 1.0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    K = grm_blocked(sub.device_packed(dev), sub.n, f32(center),
                    f32(safe_scale), block or pick_block(sub.n))
    return K.cpu().numpy().astype(np.float64), center, scale


def bed_GRM(pack, **kw):
    """GRM normalized by the number of variants."""
    K, center, scale = bed_tcrossprodSelf(pack, **kw)
    return K / pack.m
