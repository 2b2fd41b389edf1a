"""Build and load the port's hand-written native sources at first use.

Every CUDA source under `csrc/` is compiled with nvcc for sm_90a into a
shared library with a plain C interface, and every host C++ source under
`native/` with g++; both land in `_build/` (git-ignored), named by the
hash of the source, the headers beside it (`*.cuh`, `*.h`) and the flags,
and are loaded with ctypes. Nothing is
built when a module is imported: the wrappers call `load` when they first
launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_libs: dict = {}
_lock = threading.Lock()   # threads that load one source build it once


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _compiler(source: Path):
    if source.suffix == ".cu":
        return _nvcc(), NVCC_FLAGS
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: cannot build {source.name}")
    return gxx, GXX_FLAGS


def build(source, verbose: bool = False, extra=(), libs=()) -> Path:
    """Compile `source` (a path under the package) with the default flags
    plus `extra`, linked against `libs` (given after the source, e.g.
    "-l:libz.so.1"), into `_build/` unless the library for this source,
    its headers and these flags is there already; returns the library's
    path. With
    verbose, prints the compiler's report (for nvcc: ptxas' registers,
    shared memory and spills per kernel)."""
    source = Path(source)
    cc, flags = _compiler(source)
    flags = (*flags, *extra)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted((*source.parent.glob("*.cuh"),
                          *source.parent.glob("*.h"))):
        h.update(header.read_bytes())
    h.update(" ".join((*flags, *libs)).encode())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / (f".{lib_path.name}.{os.getpid()}."
                       f"{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(source), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cc).name} failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip(), flush=True)
    report(lib_path).write_text(proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def report(lib_path) -> Path:
    """Where `build` keeps the compiler's report of a library (for nvcc,
    ptxas' registers, shared memory and spills per kernel)."""
    return Path(lib_path).with_suffix(".log")


def load(source, bind, extra=(), libs=()) -> ctypes.CDLL:
    """The loaded library of `source`, built at first use (with `extra`
    flags and `libs`); `bind(lib)` sets its functions' argument and return
    types."""
    key = str(source)
    with _lock:
        if key not in _libs:
            lib = ctypes.CDLL(str(build(source, extra=extra, libs=libs)))
            bind(lib)
            _libs[key] = lib
        return _libs[key]
