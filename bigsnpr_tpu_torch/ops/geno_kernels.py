"""Fused 2-bit decode + standardized GEMM: the CUDA kernels K1/K2, their
plain-torch twins, and the operator built on them.

Counterpart of `bigsnpr_tpu/ops/pallas_kernels.py` (`pallas_cprod` /
`pallas_prod` with mxu="highest", and `PallasOperator`):

  K1 `cprod`: X~^T V, V (n, l) -> (m, l)
  K2 `prod` : X~ U,   U (m, l) -> (n, l)

with X~[i, j] = (d_ij - center_j) * inv_j for sample i of variant j, the
dosage d = 2 - ((g + 1) >> 1) of 2-bit code g, and NA (g == 1) -> 0.

The kernels live in `csrc/geno_gemm.cu`, built with nvcc at first use
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

SOURCE = cuda_build.PKG / "csrc" / "geno_gemm.cu"

# kernel launches made by the wrappers, by kernel
launches = {"cprod": 0, "prod": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(verbose: bool = False):
    """Compile `csrc/geno_gemm.cu` at first use (`cuda_build.build`);
    returns the library's path."""
    return cuda_build.build(SOURCE, verbose=verbose)


def _bind(lib):
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.geno_plan.argtypes = [i32, i64, i64, i64, i32]
    lib.geno_plan.restype = i32
    for fn in (lib.geno_cprod, lib.geno_prod):
        fn.argtypes = [ptr, i64, i64, i64, ptr, i64, ptr, ptr, ptr, ptr,
                       i32, ptr]
        fn.restype = i32


def _load():
    return cuda_build.load(SOURCE, _bind)


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
    """K1's function in torch ops: decode a variant block, f32 matmul."""
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
    """K2's function in torch ops, accumulated over variant blocks."""
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

def _check(packed, n, W, w_rows, center, inv):
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError("packed must be a 2-D uint8 tensor")
    m, nb = packed.shape
    if nb != (n + 3) // 4:
        raise ValueError(f"packed has {nb} bytes per variant, n={n} needs "
                         f"{(n + 3) // 4}")
    if W.dtype != torch.float32 or W.dim() != 2 or W.shape[0] != w_rows:
        raise ValueError(f"operand must be float32 ({w_rows}, l), got "
                         f"{W.dtype} {tuple(W.shape)}")
    for name, t in (("center", center), ("inv", inv)):
        if t.dtype != torch.float32 or tuple(t.shape) != (m,):
            raise ValueError(f"{name} must be float32 ({m},)")
    for t in (packed, W, center, inv):
        if t.device != packed.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")


def _launch(kind, packed, n, W, center, inv, rows_out):
    lib = _load()
    m, nb = packed.shape
    l = W.shape[1]
    dev = packed.device
    out = torch.empty((rows_out, l), dtype=torch.float32, device=dev)
    if min(m, n, l) == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = lib.geno_plan(0 if kind == "cprod" else 1, m, nb, l, sms)
    part = (torch.empty((splits, rows_out, l), dtype=torch.float32,
                        device=dev) if splits > 1 else out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.geno_cprod if kind == "cprod" else lib.geno_prod
    rc = fn(packed.data_ptr(), m, nb, n, W.data_ptr(), l, center.data_ptr(),
            inv.data_ptr(), out.data_ptr(), part.data_ptr(), splits, stream)
    if rc != 0:
        raise RuntimeError(f"geno_{kind} launch failed: CUDA error {rc}")
    launches[kind] += 1
    return out


def cprod(packed, n, V, center, inv):
    """K1: (m, nb) uint8 packed, V (n, l) f32, center/inv (m,) f32 ->
    (m, l) f32 = X~^T V. CUDA tensors launch the kernel; CPU tensors take
    `cprod_plain`."""
    _check(packed, n, V, n, center, inv)
    if packed.device.type == "cpu":
        return cprod_plain(packed, n, V, center, inv)
    return _launch("cprod", packed, n, V, center, inv, packed.shape[0])


def prod(packed, n, U, center, inv):
    """K2: U (m, l) f32 -> (n, l) f32 = X~ U. CUDA tensors launch the
    kernel; CPU tensors take `prod_plain`."""
    _check(packed, n, U, packed.shape[0], center, inv)
    if packed.device.type == "cpu":
        return prod_plain(packed, n, U, center, inv)
    return _launch("prod", packed, n, U, center, inv, n)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

class GenoOperator:
    """Device-resident standardized genotype operator on K1/K2, with the
    surface {n, m, cprod, prod, power, power_dev} of the JAX package's
    `PallasOperator`.

    A variant whose scale is <= 0 contributes exactly 0 (inv = 0,
    center = 2). Optional ind_row/ind_col make the operator act as the
    physically subsetted matrix would, while the packed bytes stay whole
    (and cached) on the device: inputs are scattered and outputs gathered
    on the device."""

    def __init__(self, pack, center, scale, ind_row=None, ind_col=None,
                 device=None):
        dev = config.resolve_device(device)
        self.device = dev
        self.packed = pack.device_packed(dev)
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
        return cprod(self.packed, self.n_full, V, self.center, self.inv)

    def _prod_full(self, U):
        return prod(self.packed, self.n_full, U, self.center, self.inv)

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
        """Power step on the device, K1 then K2 on one stream with no host
        round-trip: V (n, l) -> (B = X~^T V (m, l), Y = X~ B (n, l))."""
        B = self.cprod_dev(V)
        return B, self.prod_dev(B)
