"""Float32 products at the JAX package's `matmul_precision` names.

The JAX package passes its option to `jnp.dot(..., precision=...)`, and
XLA on a TPU gives the three names these meanings; the port gives them the
same meanings on the card:

  "highest"  IEEE float32 (TF32 stays off, `config`): the product exactly
             as the site computed it before the option existed;
  "high"     bf16x3: each float32 operand split into bf16 hi + lo
             (lo = bf16(x - hi)), hi·hi + hi·lo + lo·hi accumulated in
             float32 (lo·lo is dropped);
  "default"  one bf16 pass: the operands rounded to bf16, float32
             accumulation, float32 output.

On CUDA the two reduced names run bf16 tensor-core products through
PyTorch's `out_dtype` matmuls (`aten::addmm.dtype_out`,
`baddbmm.dtype_out`); "high" stacks its three terms along the
contraction, one product of depth 3k. The depth runs in pieces of
DEPTH_CHUNK, each added to the float32 result by the call's epilogue: an
H100's tensor cores lose 2e-5 to 1e-4 of the result over a depth of
6,704 to 60,000 in one call, DEPTH_CHUNK-deep pieces 1e-6 to 2e-6
(`probe_bf16_accum.py`), less than a float32 product of the same
operands loses. A missing or failing call raises: nothing falls back to
float32. On the CPU the same bf16 operands are multiplied in float32,
where each product of two bf16 values is exact and only the float32
accumulation rounds. No process-wide flag is read or changed.
"""

from __future__ import annotations

import torch

from bigsnpr_tpu_torch import config

DEPTH_CHUNK = 1024


def resolve(precision=None) -> str:
    """The name a product runs at: `precision`, else
    `config.matmul_precision`; an unknown name raises ValueError."""
    return config.check_precision(
        config.matmul_precision if precision is None else precision)


def split_bf16(x: torch.Tensor):
    """(hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def _cat(parts, dim):
    """torch.cat along `dim` (-1 or -2), keeping a transposed layout
    transposed (the operands are often `.T` views)."""
    if parts[0].dim() >= 2 and not parts[0].is_contiguous() \
            and parts[0].mT.is_contiguous():
        return torch.cat([p.mT for p in parts], -3 - dim).mT
    return torch.cat(parts, dim)


def operands(a: torch.Tensor, b: torch.Tensor, name: str):
    """bf16 (A, B) whose product, accumulated in float32, is the `name`
    product of the float32 a (..., M, K) and b (..., K, N): "default"
    the rounded operands, "high" [hi | hi | lo] against [hi; lo; hi]."""
    if name == "default":
        return a.to(torch.bfloat16), b.to(torch.bfloat16)
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return _cat([ah, ah, al], -1), _cat([bh, bl, bh], -2)


def _accumulate_bf16(acc, A, B):
    """acc (float32) += A @ B of bf16 operands on CUDA, DEPTH_CHUNK of the
    depth a call (2-D or batched)."""
    op = (torch.ops.aten.baddbmm if A.dim() == 3 else
          torch.ops.aten.addmm).dtype_out
    for k0 in range(0, A.shape[-1], DEPTH_CHUNK):
        op(acc, A[..., k0:k0 + DEPTH_CHUNK], B[..., k0:k0 + DEPTH_CHUNK, :],
           torch.float32, out=acc)
    return acc


def _new(A, B):
    return torch.zeros((*A.shape[:-1], B.shape[-1]), dtype=torch.float32,
                       device=A.device)


def mm(a, b, precision=None, out=None):
    """a @ b (2-D, float32) at `precision`; into `out` when given."""
    p = resolve(precision)
    if p == "highest":
        return torch.matmul(a, b, out=out)
    A, B = operands(a, b, p)
    if a.device.type == "cuda":
        return _accumulate_bf16(_new(A, B) if out is None else out.zero_(),
                                A, B)
    return torch.matmul(A.float(), B.float(), out=out)


def addmm_(acc, a, b, precision=None):
    """acc += a @ b in place (acc float32) at `precision`; returns acc."""
    p = resolve(precision)
    if p == "highest":
        return acc.addmm_(a, b)
    A, B = operands(a, b, p)
    if a.device.type == "cuda":
        return _accumulate_bf16(acc, A, B)
    return acc.addmm_(A.float(), B.float())


def bmm(a, b, precision=None):
    """Batched a @ b (3-D, float32) at `precision`."""
    p = resolve(precision)
    if p == "highest":
        return torch.bmm(a, b)
    A, B = operands(a, b, p)
    if a.device.type == "cuda":
        return _accumulate_bf16(_new(A, B), A, B)
    return torch.bmm(A.float(), B.float())
