"""Global configuration: device choice, matmul precision, scoped options.

Mirrors `bigsnpr_tpu/config.py`. Entry points run on the CUDA device unless
the caller asks for the CPU, either globally (`set_device("cpu")`) or per
call (`device="cpu"`). With no CUDA and no request for the CPU an entry
point raises: there is no silent fallback.

matmul_precision: the JAX package's speed-for-accuracy option of the same
name (env BIGSNPR_MATMUL_PRECISION, default "highest"), read by the float32
torch products that port the JAX package's XLA products which read it
(`ops/precision.py`, port DEVIATIONS #36): "highest" is IEEE float32,
"high" bf16x3 and "default" one bf16 pass with float32 accumulation, their
meanings on a TPU. Every other product is IEEE float32: TF32 is switched
off here once, and the option never changes a process-wide flag.
`dot_precision()` returns the name (torch has no precision enum).

pallas_mxu: the scheme of the genotype operator's kernels, the JAX
package's option of the same name (env BIGSNPR_PALLAS_MXU): "highest"
(float32 decode + GEMM, K1/K2), "split2" (exact bf16 bit planes against
the operand split into bf16 hi + lo, K7) or "int8" (exact int8 bit
planes, K6). As in the JAX package, the option refuses "int8m" (K8, the
int8 planes materialized once): that scheme is reached only through an
operator built with it, `GenoOperator(..., mxu="int8m")`.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

device: str = "cuda"
MATMUL_PRECISIONS = ("default", "high", "highest")
# read as the JAX package reads it; checked where a product reads it
matmul_precision: str = os.environ.get("BIGSNPR_MATMUL_PRECISION", "highest")
# read as the JAX package reads it; an operator checks it when built
pallas_mxu: str = os.environ.get("BIGSNPR_PALLAS_MXU", "highest")


def set_device(name: str) -> None:
    """Default device of every entry point ("cuda", "cuda:1", "cpu")."""
    global device
    torch.device(name)  # validates the string
    device = name


def resolve_device(dev=None) -> torch.device:
    """The device a call runs on: `dev` if given, else the configured one.

    Raises when that is a CUDA device and no CUDA device is present."""
    d = torch.device(device if dev is None else dev)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bigsnpr_tpu_torch: no CUDA device is available; pass "
            "device='cpu' or call config.set_device('cpu') to run on the CPU")
    return d


def check_precision(name: str) -> str:
    """`name` if it is one of MATMUL_PRECISIONS, else ValueError."""
    if name not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision must be one of "
                         f"{MATMUL_PRECISIONS}, not {name!r}")
    return name


def set_matmul_precision(name: str) -> None:
    """The precision of the products that read the option."""
    global matmul_precision
    matmul_precision = check_precision(name)


def dot_precision() -> str:
    """The current `matmul_precision`, checked (the JAX package returns
    its `jax.lax.Precision`; torch has no such enum)."""
    return check_precision(matmul_precision)


MXU_SCHEMES = ("highest", "split2", "int8")
# schemes an operator takes; "int8m" only by its constructor's argument
OPERATOR_SCHEMES = MXU_SCHEMES + ("int8m",)


def resolve_mxu(mxu=None) -> str:
    """The genotype operator's scheme: `mxu`, else `pallas_mxu`."""
    mxu = pallas_mxu if mxu is None else mxu
    if mxu not in OPERATOR_SCHEMES:
        raise ValueError(f"unknown operator scheme {mxu!r}; one of "
                         f"{OPERATOR_SCHEMES}")
    return mxu


def get_option(name: str):
    from bigsnpr_tpu_torch.utils import assertions

    if name == "device":
        return device
    if name == "matmul_precision":
        return matmul_precision
    if name == "pallas_mxu":
        return pallas_mxu
    if name == "check_args":
        return assertions.get_check_args()
    raise KeyError(name)


def set_option(name: str, value) -> None:
    global pallas_mxu
    from bigsnpr_tpu_torch.utils import assertions

    if name == "device":
        set_device(value)
    elif name == "matmul_precision":
        set_matmul_precision(value)
    elif name == "pallas_mxu":
        if value not in MXU_SCHEMES:
            raise ValueError(
                f"pallas_mxu must be one of {MXU_SCHEMES}, not {value!r}"
                + ('; the "int8m" scheme (kernel K8) is reached through '
                   'GenoOperator(..., mxu="int8m")' if value == "int8m"
                   else ""))
        pallas_mxu = value
    elif name == "check_args":
        assertions.set_check_args(bool(value))
    else:
        raise KeyError(name)


@contextmanager
def options(**kw):
    """Scoped option override: `with options(device="cpu",
    matmul_precision="default"):`"""
    old = {k: get_option(k) for k in kw}
    try:
        for k, v in kw.items():
            set_option(k, v)
        yield
    finally:
        for k, v in old.items():
            set_option(k, v)


def enable_compilation_cache(path: str | None = None) -> str:
    """Build the port's native libraries (nvcc and g++, `ops/cuda_build`)
    into `path`, by default $BIGSNPR_COMPILE_CACHE, else the package's
    `_build/` (where they go without this call). Creates the directory and
    returns it. A library is named by the hash of its source, the headers
    beside it and the flags, so a second process reuses what the first
    built. The JAX package's function of this name persists XLA's
    compilations instead."""
    from bigsnpr_tpu_torch.ops import cuda_build

    path = str(path or os.environ.get("BIGSNPR_COMPILE_CACHE")
               or cuda_build.DEFAULT_BUILD_DIR)
    os.makedirs(path, exist_ok=True)
    cuda_build.set_build_dir(path)
    return path
