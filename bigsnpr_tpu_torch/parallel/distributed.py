"""Several processes: torch.distributed under the mesh (port of
`bigsnpr_tpu/parallel/distributed.py`).

The reference has no distributed backend (SURVEY.md §2.8). Here each
rank of a torch.distributed job owns one shard of the ('s', 'v') mesh
(`global_mesh`), reads only its own bytes of the `.bed` (its variant
rows and sample byte columns, `shard_pack_distributed`), and the
products' partials are summed over the mesh's subgroups exactly as in
the single-process mesh (`parallel/mesh.py`).

Launch one process a card, e.g. `torchrun --nproc-per-node N script.py`
(rank and world size from its environment, backend "nccl"), or start the
ranks yourself and pass `coordinator_address`, `num_processes` and
`process_id`. The backend is stated, never found by trying one: the
caller's, else "nccl" for a CUDA device and "gloo" for the CPU. NCCL
takes one rank a card; two ranks on one card run on "gloo" (which also
moves CUDA tensors), named by the caller.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.parallel.mesh import (Mesh, MeshOperator, Sharded,
                                             colstats_fn, factor_mesh,
                                             make_mesh, put_global,
                                             shard_tiles)

# the device of this rank, set by init_distributed
_RANK_DEVICE: list = []


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def rank_device(device=None, process_id: int = 0) -> torch.device:
    """This rank's device: `device`, else the configured one, a bare
    "cuda" taking card LOCAL_RANK (or process_id) modulo the card count."""
    dev = config.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = _env_int("LOCAL_RANK")
        local = process_id if local is None else local
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None) -> bool:
    """`torch.distributed.init_process_group` for this rank; a no-op
    returning False for one process when no backend is named.

    coordinator_address: "host:port" (tcp), or an init_method URL
    ("tcp://...", "file://..."); None reads torchrun's environment, as do
    num_processes / process_id (WORLD_SIZE / RANK). backend: as given,
    else "nccl" for a CUDA device and "gloo" for the CPU."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE") or 1
    if process_id is None:
        process_id = _env_int("RANK") or 0
    if num_processes <= 1 and backend is None:
        return False
    dev = rank_device(device, process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator_address
    if init is None:
        init = "env://"
    elif "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    _RANK_DEVICE[:] = [dev]
    return True


def global_mesh(shape=None, device=None) -> Mesh:
    """The (s, v) mesh of the job, one shard a rank (near-square by
    default, `factor_mesh`); without torch.distributed, `make_mesh` over
    this process's devices."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(device=device)
    world = dist.get_world_size()
    shape = factor_mesh(world) if shape is None else tuple(shape)
    dev = (torch.device(device) if device is not None
           else _RANK_DEVICE[0] if _RANK_DEVICE
           else rank_device(None, dist.get_rank()))
    return Mesh.across_processes(shape, dist.get_rank(), dev)


def host_local_shard(mesh: Mesh, packed_local, axis: str = "s") -> Sharded:
    """The global ("v", "s") packed array from the tiles this process
    holds: packed_local is its one tile (padded, as `shard_pack` pads) or
    a {coord: tile} dict."""
    parts = packed_local if isinstance(packed_local, dict) else {
        mesh.local[0]: packed_local}
    parts = {c: torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                                else t).to(mesh.device_of(c))
             for c, t in parts.items()}
    rows, cols = next(iter(parts.values())).shape
    return Sharded(mesh, ("v", axis),
                   (rows * mesh.shape["v"], cols * mesh.shape[axis]), parts)


def shard_slice(total: int, process_id: int, num_processes: int,
                quantum: int = 1) -> slice:
    """This host's contiguous shard of `total` items, in multiples of
    `quantum` (byte-columns of the packed store use quantum=1; raw
    samples use quantum=4 = samples per packed byte)."""
    units = -(-total // quantum)
    per = -(-units // num_processes)
    lo = min(process_id * per, units)
    hi = min(lo + per, units)
    return slice(lo * quantum, min(hi * quantum, total))


def bed_shard_bytes(bedfile, process_id: int, num_processes: int):
    """This process's sample shard of a .bed: the memory-mapped body's
    byte columns `shard_slice` gives it, read by no one else.

    Returns (packed_local (m, nb_local) memmap view, n, m, nb_total,
    byte_lo). Sample boundaries stay byte-aligned (4 samples a byte)."""
    from bigsnpr_tpu_torch.io.bed import read_bed

    pack = read_bed(bedfile, mmap=True)
    m, nb = pack.packed.shape
    sl = shard_slice(nb, process_id, num_processes)
    return pack.packed[:, sl], pack.n, m, nb, sl.start


def replicated(mesh: Mesh, arr, spec) -> Sharded:
    """A global array from the same full array in every process, each
    taking only its own shards' blocks (`put_global`)."""
    return put_global(mesh, arr, spec)


def shard_pack_distributed(bedfile, mesh: Mesh):
    """The packed ("v", "s") array of a .bed in which each process reads
    only the bytes of its own tiles (its variant rows and sample byte
    columns) from the memory-mapped body, under `shard_pack`'s padding:
    pad bytes and the tail byte's spare bits decode as NA.

    Returns (packed (m_pad, nb_pad), n, m, n_pad)."""
    from bigsnpr_tpu_torch.io.bed import read_bed

    pack = read_bed(bedfile, mmap=True)
    body = pack.packed
    m, nb = body.shape

    def read(r0, r1, c0, c1, dev):
        return torch.from_numpy(np.array(body[r0:r1, c0:c1]))

    packed, n_pad = shard_tiles(mesh, read, pack.n, m, nb)
    return packed, pack.n, m, n_pad


def distributed_binom_operator(bedfile, mesh: Mesh | None = None,
                               precision: str = "highest"):
    """A MeshOperator over a .bed with the binomial scaling computed on
    the mesh (exact per-variant counts summed over "s": the distributed
    bed_scaleBinom, R/binom-scaling.R:133-142).

    Returns (op, {"center", "scale"}), the same float64 host vectors in
    every process."""
    if mesh is None:
        mesh = global_mesh()
    packed, n, m, n_pad = shard_pack_distributed(bedfile, mesh)
    sums, _, nona = colstats_fn(mesh)(packed)[:, :m].astype(np.float64)
    af = sums / np.maximum(2.0 * nona, 1.0)
    center = 2.0 * af
    scale = np.sqrt(2.0 * af * (1.0 - af))
    op = MeshOperator.from_sharded(packed, n, m, n_pad, center, scale, mesh,
                                   precision=precision)
    return op, {"center": center, "scale": scale}

