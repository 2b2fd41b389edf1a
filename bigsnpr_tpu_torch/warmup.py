"""Deliberate build and first launch of the port's kernels (port of
`bigsnpr_tpu/warmup.py`).

The JAX package compiles its XLA / Pallas programs ahead at the shapes a
later call will use. On a GPU nothing is compiled per shape: the port's
hand-written kernels are built from their sources at first use
(`ops/cuda_build.py`: nvcc for `csrc/*.cu`, g++ for `native/*.cpp`). So
`warmup` does two things:
  - builds and loads every source, the CUDA ones with one nvcc each,
    started together (on the CPU only the native host libraries);
  - launches each kernel once at the given shapes on zero data made on the
    device (no host upload): the genotype operator's power step (K1 then
    K2, or the kernels of `config.pallas_mxu`) and one sweep of the
    chain-batched LDpred2 sampler (and of the grid, with grid_cells).
With device="cpu" the launches run the kernels' plain twins.

Reference context: the reference has no compile step (R/C++ are AOT), so
this subsystem has no reference twin.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bigsnpr_tpu_torch import config


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_all(device=None, verbose: bool = False) -> float:
    """Build and load every native source (and, on CUDA, every CUDA
    source, one nvcc each, in parallel); returns seconds spent."""
    from bigsnpr_tpu_torch.io import bgen
    from bigsnpr_tpu_torch.linalg import penalized
    from bigsnpr_tpu_torch.ops import clumping, cuda_build, splitld
    from bigsnpr_tpu_torch.ops import geno_kernels as gk
    from bigsnpr_tpu_torch.ops import gibbs_kernels as gsk

    dev = config.resolve_device(device)
    t0 = time.perf_counter()
    loads = [lambda: cuda_build.load(penalized.SOURCE, penalized._bind),
             lambda: cuda_build.load(clumping.CLUMP_SOURCE,
                                     clumping._bind_clump),
             lambda: cuda_build.load(splitld.SOURCE, splitld._bind),
             bgen._lib]
    if dev.type == "cuda":
        loads += [gk._load_i8, gk._load_split, gsk._load]
    with ThreadPoolExecutor(len(loads)) as pool:
        list(pool.map(lambda f: f(), loads))
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[warmup] built and loaded {len(loads)} libraries: "
              f"{dt:.1f}s")
    return dt


def _zeros_pack(m: int, n: int, dev):
    """GenoPack of shape (m, n) whose device copy is made on the device
    (no host->device transfer of the packed bytes)."""
    from bigsnpr_tpu_torch.core.genotypes import GenoPack

    nb = (n + 3) // 4
    pack = GenoPack(packed=np.zeros((m, nb), np.uint8), n=n)
    pack._device_cache[str(dev)] = torch.zeros((m, nb), dtype=torch.uint8,
                                               device=dev)
    return pack


def warmup_svd(m: int, n: int, k: int = 10, oversample: int = 10,
               max_iter: int = 200, nona: bool = False,
               verbose: bool = False, device=None) -> float:
    """One power step of the genotype operator of an (m, n) pack at the
    width snp_randomSVD(k, oversample) uses: K1 then K2 once each (or the
    kernels of `config.pallas_mxu`), on zeros made on the device. nona
    picks the NA-free kernels of the int8 scheme. Returns seconds spent."""
    from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator

    dev = config.resolve_device(device)
    t0 = time.perf_counter()
    op = GenoOperator(_zeros_pack(m, n, dev), np.zeros(m), np.ones(m),
                      device=dev, nona=nona)
    l0 = min(k + oversample, min(n, m))
    op.power_dev(torch.zeros((n, l0), dtype=torch.float32, device=dev))
    _sync(dev)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[warmup] randomSVD power step {m}x{n} l={l0}: {dt:.1f}s")
    return dt


def warmup_gibbs(m: int, block: int = 4096, W: int = 250, chains: int = 30,
                 grid_cells: int = 0, use_mle: bool = True,
                 verbose: bool = False, device=None) -> float:
    """One sweep of the chain-batched LDpred2-auto sampler (and of the
    grid sampler with grid_cells) on zero bands of `block`-sized blocks of
    half-width W over m variants, the shapes build_block_bands would make.
    Returns seconds spent."""
    from bigsnpr_tpu_torch.pgs import gibbs_blocked as gb
    from bigsnpr_tpu_torch.pgs.gibbs import chain_generators

    dev = config.resolve_device(device)
    t0 = time.perf_counter()
    nb = max(m // block, 1)
    mbk = gb._round_up(block)
    Wk = (gb._round_up(2 * W + 1) - 1) // 2
    bands = np.zeros((nb, mbk, 2 * Wk + 1), np.float32)
    bands[:, :, Wk] = 1.0                      # unit diagonal
    gidx = np.full((nb, mbk), -1, np.int32)
    for b in range(nb):
        sz = min(block, m - b * block)
        gidx[b, :sz] = b * block + np.arange(sz)
    sb = gb.BlockBands([(bands, gidx)], m).device_put(dev)
    bh = np.zeros(m, np.float32)
    nv = np.full(m, 1e5, np.float32)
    gb.gibbs_auto_blocked_multi(
        sb, bh, nv, np.zeros(m, np.float32), np.full(chains, 0.1), 0.3,
        chain_generators(0, chains, dev), 1.0, (1e-5, 1.0), (-0.5, 1.5),
        5.0, burn_in=0, num_iter=1, use_mle=use_mle)
    if grid_cells:
        gb.gibbs_multi_blocked(
            sb, bh, nv, np.full(grid_cells, 0.3), np.full(grid_cells, 0.1),
            np.zeros(grid_cells, bool), chain_generators(1, grid_cells, dev),
            burn_in=0, num_iter=1)
    _sync(dev)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[warmup] gibbs m={m} block={block} W={W} x{chains} chains"
              f"{f' + {grid_cells} cells' if grid_cells else ''}: {dt:.1f}s")
    return dt


def warmup(m: int | None = None, n: int | None = None, k: int = 10,
           gibbs_m: int | None = None, gibbs_block: int = 4096,
           gibbs_W: int = 250, chains: int = 30, grid_cells: int = 21,
           nona: bool = False, verbose: bool = True, device=None) -> dict:
    """Build every kernel and launch each once, deliberately.

    warmup(m, n, k=10) covers the PCA path (the operator's power step);
    gibbs_m adds the chain-batched LDpred2 sweep. Returns {section:
    seconds}: the JAX package's sections ("svd", "gibbs") and "build" (the
    sources built and loaded). Run once per process."""
    dev = config.resolve_device(device)
    out = {"build": build_all(dev, verbose=verbose)}
    if m is not None and n is not None:
        out["svd"] = warmup_svd(m, n, k=k, nona=nona, verbose=verbose,
                                device=dev)
    if gibbs_m is not None:
        out["gibbs"] = warmup_gibbs(gibbs_m, block=gibbs_block, W=gibbs_W,
                                    chains=chains, grid_cells=grid_cells,
                                    verbose=verbose, device=dev)
    return out
