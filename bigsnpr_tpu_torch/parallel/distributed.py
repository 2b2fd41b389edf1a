"""Several processes: torch.distributed under the mesh (port of
`bigsnpr_tpu/parallel/distributed.py`).

The reference has no distributed backend (SURVEY.md §2.8). Here each
rank of a torch.distributed job holds L shards of the ('s', 'v') mesh
(`global_mesh`), one on each of its devices (`rank_devices`), reads only
its own tiles' bytes of the `.bed` (their variant rows and sample byte
columns, `shard_pack_distributed`), and the products' partials are
summed over the mesh exactly as in the single-process mesh
(`parallel/mesh.py`).

Two launches, both on "nccl":
  - one rank a card: `torchrun --nproc-per-node N script.py` (rank,
    world size, LOCAL_RANK and LOCAL_WORLD_SIZE from its environment);
  - one process a host holding all of its cards, the JAX package's
    layout: `torchrun --nproc-per-node 1 --nnodes H ...`, or start the
    processes yourself and pass `coordinator_address`, `num_processes`
    and `process_id`.
A rank's devices are the cards it sees split evenly among the ranks of
its host, unless the caller names them. The backend is stated, never
found by trying one: the caller's, else "nccl" for a CUDA device and
"gloo" for the CPU. NCCL takes one rank a card; two ranks on one card
run on "gloo" (which also moves CUDA tensors), named by the caller.
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

# the devices of this rank, set by init_distributed
_RANK_DEVICES: list = []


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def rank_devices(device=None) -> list:
    """This rank's devices, one a shard: `device` (else the configured
    one) when it is the CPU or names one card; else, for a bare "cuda",
    the cards this process sees split evenly among the LOCAL_WORLD_SIZE
    ranks of its host (1 when unset), rank LOCAL_RANK (0) taking a
    contiguous run from LOCAL_RANK * count / LOCAL_WORLD_SIZE; where the
    host has more ranks than cards, card LOCAL_RANK modulo the count.
    With no card and no request for the CPU this raises, as every entry
    point does."""
    dev = config.resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    count = torch.cuda.device_count()
    local_world = _env_int("LOCAL_WORLD_SIZE") or 1
    local = _env_int("LOCAL_RANK") or 0
    if count % local_world == 0:
        per = count // local_world
        return [torch.device("cuda", local * per + i) for i in range(per)]
    if local_world % count == 0:
        return [torch.device("cuda", local % count)]
    raise ValueError(f"{count} cards do not split evenly among the "
                     f"{local_world} ranks of this host: name each rank's "
                     "devices")


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None) -> bool:
    """`torch.distributed.init_process_group` for this rank; a no-op
    returning False for one process when no backend is named.

    coordinator_address: "host:port" (tcp), or an init_method URL
    ("tcp://...", "file://..."); None reads torchrun's environment, as do
    num_processes / process_id (WORLD_SIZE / RANK). device: the rank's
    devices are `rank_devices(device)`, kept for `global_mesh`. backend:
    as given, else "nccl" for CUDA devices and "gloo" for the CPU."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE") or 1
    if process_id is None:
        process_id = _env_int("RANK") or 0
    if num_processes <= 1 and backend is None:
        return False
    devs = rank_devices(device)
    if backend is None:
        backend = "nccl" if devs[0].type == "cuda" else "gloo"
    if devs[0].type == "cuda":
        torch.cuda.set_device(devs[0])
    init = coordinator_address
    if init is None:
        init = "env://"
    elif "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    _RANK_DEVICES[:] = devs
    return True


def global_mesh(shape=None, device=None, devices=None) -> Mesh:
    """The (s, v) mesh of the job, each rank holding one shard on each of
    its devices (`devices`, else `rank_devices(device)` when device is
    given, else those `init_distributed` chose), the JAX package's layout
    (`Mesh.across_processes`); near-square by default (`factor_mesh` of
    every shard). Without torch.distributed, `make_mesh` over `devices`,
    else over this process's devices."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(devices=devices, device=device)
    if devices is None:
        devices = (rank_devices(device) if device is not None or not
                   _RANK_DEVICES else list(_RANK_DEVICES))
    devices = [torch.device(d) for d in devices]
    world = dist.get_world_size()
    shape = (factor_mesh(world * len(devices)) if shape is None
             else tuple(shape))
    return Mesh.across_processes(shape, dist.get_rank(), devices)


def host_local_shard(mesh: Mesh, packed_local, axis: str = "s") -> Sharded:
    """The global ("v", "s") packed array from the tiles this process
    holds: packed_local is a {coord: tile} dict (padded, as `shard_pack`
    pads), or the one tile of a process that holds one shard."""
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
    only the bytes of its own tiles (their variant rows and sample byte
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

