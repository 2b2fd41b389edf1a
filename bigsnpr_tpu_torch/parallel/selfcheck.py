"""A multi-process run of the mesh operator, for checks: each rank of a
torch.distributed job holds L shards of the mesh, reads only its own
tiles of a .bed (`distributed_binom_operator`), runs cprod, prod and
power on seeded operands and `snp_randomSVD(op=, engine="mesh")`, and
writes what it got to OUT/rank{r}.npz; the caller compares the ranks with
each other and with one process (`products` on an in-process mesh).

    python -m bigsnpr_tpu_torch.parallel.selfcheck --rank R --world W \\
        --init file:///tmp/store --bed cohort.bed --out DIR \\
        [--backend gloo|nccl] [--device cpu|cuda:0] [--shape S V] \\
        [--shards-per-rank L] [--k K] [--tol T]

`--shards-per-rank L` puts L shards on the rank's device, or one on each
of its L cards (`distributed.rank_devices`). `spawn` (`start`, then
`collect`) runs the W ranks as subprocesses on one host and returns
their results.
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
KEYS = ("B", "Y", "Bp", "Yp", "d", "u", "v", "niter", "center", "scale",
        "center_mesh")


def products(op, sc, k: int = 5, l: int = 3, seed: int = 0,
             tol: float = 1e-7) -> dict:
    """cprod, prod and power of a mesh operator on seeded operands, and
    snp_randomSVD on it; center_mesh: the operator's float32 centers
    fetched from the mesh (`fetch_global`): {KEYS: numpy}."""
    from bigsnpr_tpu_torch.linalg.randomsvd import snp_randomSVD
    from bigsnpr_tpu_torch.parallel.mesh import fetch_global

    rng = np.random.default_rng(seed)
    V = rng.standard_normal((op.n, l)).astype(np.float32)
    U = rng.standard_normal((op.m, l)).astype(np.float32)
    B, Y = op.cprod(V), op.prod(U)
    Bp, Yp = op.power(V)
    svd = snp_randomSVD(None, fun_scaling=sc, k=k, tol=tol, op=op,
                        engine="mesh")
    return dict(B=B, Y=Y, Bp=Bp, Yp=Yp, d=svd.d, u=svd.u, v=svd.v,
                niter=svd.niter, center=sc["center"], scale=sc["scale"],
                center_mesh=fetch_global(op.center))


def run(rank: int, world: int, init: str, bed: str, out: str, backend=None,
        device=None, shape=None, shards_per_rank: int = 1, k: int = 5,
        l: int = 3, seed: int = 0, tol: float = 1e-7) -> str:
    """One rank's part; returns the path of its .npz."""
    import torch.distributed as dist

    from bigsnpr_tpu_torch import config
    from bigsnpr_tpu_torch.ops import geno_kernels
    from bigsnpr_tpu_torch.parallel import distributed as pdist

    if device is not None:
        config.set_device(device)
    devices = pdist.rank_devices(device)
    if len(devices) == 1:              # L shards on the rank's one device
        devices = devices * shards_per_rank
    if len(devices) != shards_per_rank:
        raise ValueError(f"{shards_per_rank} shards a rank asked, the rank "
                         f"has {len(devices)} devices")
    pdist.init_distributed(init, world, rank, backend=backend,
                           device=devices[0])
    try:
        t0 = time.perf_counter()
        mesh = pdist.global_mesh(shape, devices=devices)
        geno_kernels.reset_launches()
        op, sc = pdist.distributed_binom_operator(bed, mesh)
        res = products(op, sc, k=k, l=l, seed=seed, tol=tol)
        seconds = time.perf_counter() - t0
        path = os.path.join(out, f"rank{rank}.npz")
        np.savez(path, **res, world=dist.get_world_size(),
                 backend=dist.get_backend(),
                 mesh=np.asarray([mesh.shape["s"], mesh.shape["v"]]),
                 coords=np.asarray(mesh.local),
                 cprod=geno_kernels.launches["cprod"],
                 prod=geno_kernels.launches["prod"], seconds=seconds,
                 device=str(mesh.device))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return path


def start(world: int, bed, out, backend=None, device=None, shape=None,
          shards_per_rank: int = 1, k: int = 5, tol: float = 1e-7,
          prefix=None, env=None):
    """Start the `world` ranks as subprocesses of this host against a file
    store in `out` (each rank's output goes to OUT/rank{r}.log); returns
    the job for `collect`. prefix: the command before the arguments
    (default: this Python running the module)."""
    os.makedirs(out, exist_ok=True)
    store = os.path.join(os.path.abspath(out), f"store-{time.time_ns()}")
    prefix = prefix or [sys.executable, "-m", MODULE]
    args = ["--world", str(world), "--init", f"file://{store}", "--bed",
            str(bed), "--out", str(out), "--shards-per-rank",
            str(shards_per_rank), "--k", str(k), "--tol", str(tol)]
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
    ap.add_argument("--shards-per-rank", type=int, default=1)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-7)
    a = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(2, torch.get_num_threads())))
    run(a.rank, a.world, a.init, a.bed, a.out, backend=a.backend,
        device=a.device, shape=a.shape, shards_per_rank=a.shards_per_rank,
        k=a.k, tol=a.tol)


if __name__ == "__main__":
    main()
