"""A multi-process run of the mesh operator, for checks: each rank of a
torch.distributed job reads only its own tile of a .bed
(`distributed_binom_operator`), runs cprod, prod and power on seeded
operands and `snp_randomSVD(op=, engine="mesh")`, and writes what it got
to OUT/rank{r}.npz; the caller compares the ranks with each other and
with one process.

    python -m bigsnpr_tpu_torch.parallel.selfcheck --rank R --world W \\
        --init file:///tmp/store --bed cohort.bed --out DIR \\
        [--backend gloo|nccl] [--device cpu|cuda:0] [--shape S V] [--k K] \\
        [--tol T]

`spawn` (`start`, then `collect`) runs the W ranks as subprocesses on
one host and returns their results.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

MODULE = "bigsnpr_tpu_torch.parallel.selfcheck"


def run(rank: int, world: int, init: str, bed: str, out: str, backend=None,
        device=None, shape=None, k: int = 5, l: int = 3, seed: int = 0,
        tol: float = 1e-7) -> str:
    """One rank's part; returns the path of its .npz."""
    import torch.distributed as dist

    from bigsnpr_tpu_torch import config
    from bigsnpr_tpu_torch.linalg.randomsvd import snp_randomSVD
    from bigsnpr_tpu_torch.ops import geno_kernels
    from bigsnpr_tpu_torch.parallel import distributed as pdist

    if device is not None:
        config.set_device(device)
    pdist.init_distributed(init, world, rank, backend=backend, device=device)
    try:
        t0 = time.perf_counter()
        mesh = pdist.global_mesh(shape)
        geno_kernels.reset_launches()
        op, sc = pdist.distributed_binom_operator(bed, mesh)
        rng = np.random.default_rng(seed)
        V = rng.standard_normal((op.n, l)).astype(np.float32)
        U = rng.standard_normal((op.m, l)).astype(np.float32)
        B, Y = op.cprod(V), op.prod(U)
        Bp, Yp = op.power(V)
        svd = snp_randomSVD(None, fun_scaling=sc, k=k, tol=tol, op=op,
                            engine="mesh")
        seconds = time.perf_counter() - t0
        path = os.path.join(out, f"rank{rank}.npz")
        np.savez(path, B=B, Y=Y, Bp=Bp, Yp=Yp, d=svd.d, u=svd.u, v=svd.v,
                 niter=svd.niter, center=sc["center"], scale=sc["scale"],
                 world=dist.get_world_size(), backend=dist.get_backend(),
                 mesh=np.asarray([mesh.shape["s"], mesh.shape["v"]]),
                 coord=np.asarray(mesh.local[0]),
                 cprod=geno_kernels.launches["cprod"],
                 prod=geno_kernels.launches["prod"], seconds=seconds,
                 device=str(mesh.device))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return path


def start(world: int, bed, out, backend=None, device=None, shape=None,
          k: int = 5, tol: float = 1e-7, prefix=None, env=None):
    """Start the `world` ranks as subprocesses of this host against a file
    store in `out` (each rank's output goes to OUT/rank{r}.log); returns
    the job for `collect`. prefix: the command before the arguments
    (default: this Python running the module)."""
    os.makedirs(out, exist_ok=True)
    store = os.path.join(os.path.abspath(out), f"store-{time.time_ns()}")
    prefix = prefix or [sys.executable, "-m", MODULE]
    args = ["--world", str(world), "--init", f"file://{store}", "--bed",
            str(bed), "--out", str(out), "--k", str(k), "--tol", str(tol)]
    if backend:
        args += ["--backend", backend]
    if device:
        args += ["--device", str(device)]
    if shape:
        args += ["--shape", *map(str, shape)]
    logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [*prefix, "--rank", str(r), *args], env=env, stdout=f,
                stderr=subprocess.STDOUT))
    return out, procs, logs


def collect(job, timeout: float = 120.0):
    """Wait for a job's ranks; returns their .npz contents by rank. A rank
    that fails, or outlasts `timeout` seconds, ends every rank and
    raises."""
    out, procs, logs = job
    t_end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, open(logs[r]).read()[-3000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"selfcheck ranks failed: {bad}")
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(len(procs))]


def spawn(world: int, bed, out, timeout: float = 120.0, **kw):
    """`start` the ranks and `collect` them."""
    return collect(start(world, bed, out, **kw), timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--bed", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend")
    ap.add_argument("--device")
    ap.add_argument("--shape", type=int, nargs=2)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-7)
    a = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(2, torch.get_num_threads())))
    run(a.rank, a.world, a.init, a.bed, a.out, backend=a.backend,
        device=a.device, shape=a.shape, k=a.k, tol=a.tol)


if __name__ == "__main__":
    main()
