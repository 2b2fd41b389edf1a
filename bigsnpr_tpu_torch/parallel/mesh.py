"""Device-mesh sharding for genotype linear algebra (port of
`bigsnpr_tpu/parallel/mesh.py`).

The packed genotype matrix is split over a 2-D mesh of shards:

  axis 's' (samples): the packed byte axis; the partial products X~ᵀV of
      the shards of one variant block are summed over 's' (the
      reference's per-thread accumulators and final rowSums,
      src/bed-prod-vec.cpp:27-53, become a sum over shards);
  axis 'v' (variants): variant blocks; the partial products X~U are
      summed over 'v'.

One power step X~(X~ᵀQ) uses both sums. Each shard runs the kernels K1
(X~ᵀV) and K2 (X~U) of `ops/geno_kernels.py` on its own tile with its
variants' center and 1/scale (on the CPU, their plain twins), where the
JAX package runs `jnp.dot` under `shard_map`.

A mesh lives in one process or across processes:
  - in one process (`make_mesh`), every shard is a torch device and a
    device may repeat (four shards on one card, eight on the CPU);
  - across processes (`parallel.distributed.global_mesh`), each rank of
    torch.distributed holds L shards, the same L on every rank: the
    shards are laid out as the JAX package lays `jax.devices()` (by
    process, then by local device) over the (s, v) grid, so rank r holds
    the shards r * L ... r * L + L - 1 in row-major order. L = 1 is
    torchrun's layout (one rank a card); L = the cards of a host is the
    JAX package's (one process a host).

Every sum over an axis adds the shards' partials in shard order 0, 1, ...
on one device, so every shard of a group holds the same bits, whichever
process holds it. Across processes the ranks that hold shards of one
axis group exchange, together with every rank that shares a group with
them (`_components`: the groups of such ranks overlap, so they exchange
as one): one `all_reduce` of a buffer with a slot for each shard of the
component, in which each rank fills only its own shards' slots (a value
plus zeros is exact); each shard then adds its group's slots in order.
A component of one rank does not communicate. Gathering a result to
every rank is the same exchange. Only tall-skinny factors are gathered,
never the packed matrix.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from bigsnpr_tpu_torch import config
from bigsnpr_tpu_torch.core.unpack import unpack_codes
from bigsnpr_tpu_torch.ops import geno_kernels
from bigsnpr_tpu_torch.ops.blocks import pick_block
from bigsnpr_tpu_torch.ops.corr import pair_gram

AXES = ("s", "v")
NA_BYTE = 0b01010101  # four PLINK NA codes in one byte


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """Factor n_devices into (samples, variants) axes, near-square."""
    s = int(np.sqrt(n_devices))
    while n_devices % s:
        s -= 1
    return s, n_devices // s


def ordered_sum(parts, device):
    """parts[0] + parts[1] + ... on `device`, in that order."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def _with(coord, axis: int, i: int):
    c = list(coord)
    c[axis] = i
    return tuple(c)


def _components(shape, owner, axis: int):
    """The exchanges of a sum over `axis` across processes: [(ranks,
    shards)], the ranks (sorted) that hold shards of axis groups linked
    by a common rank, and every shard of those groups in row-major
    order. owner maps a coordinate to its rank."""
    S, V = shape
    groups = {}                             # group key -> its shards
    for si in range(S):
        for vi in range(V):
            key = vi if axis == 0 else si
            groups.setdefault(key, []).append((si, vi))
    comps = []                              # [(ranks, group keys)]
    for key, shards in groups.items():
        ranks = {owner[c] for c in shards}
        keys = [key]
        for comp in [c for c in comps if c[0] & ranks]:
            comps.remove(comp)
            ranks |= comp[0]
            keys += comp[1]
        comps.append((ranks, keys))
    out = [(sorted(ranks), sorted(c for k in keys for c in groups[k]))
           for ranks, keys in comps]
    return sorted(out)


class Mesh:
    """An (s, v) grid of shards, axis names "s" and "v".

    `Mesh(devices)` holds every shard in this process: devices is an (s,
    v) nested sequence, one device a shard (a device may repeat).
    `Mesh.across_processes` holds this rank's L shards. `local` lists
    the (si, vi) coordinates of the shards this process holds, in shard
    order; `device` is the first one's device, where gathered results
    live and through which this process exchanges."""

    def __init__(self, devices):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("devices must be a non-empty (s, v) grid")
        self.shape = {"s": len(grid), "v": len(grid[0])}
        self.distributed = False
        self.exchanges = None
        self._dev = {(si, vi): d for si, row in enumerate(grid)
                     for vi, d in enumerate(row)}

    @classmethod
    def across_processes(cls, shape, rank: int, devices):
        """The mesh of a torch.distributed job whose ranks each hold L =
        len(devices) shards, rank r the shards r * L ... r * L + L - 1 of
        the row-major (s, v) grid, on devices in that order. The world
        must be s * v / L ranks (so every rank has the same L). Every rank
        must call this, with the same shape: each makes every exchange's
        process group, in one order."""
        S, V = shape
        devices = [torch.device(d) for d in devices]
        L, world = len(devices), dist.get_world_size()
        if S * V != world * L:
            raise ValueError(f"a {S} x {V} mesh has {S * V} shards; the "
                             f"job's {world} ranks of {L} shards hold "
                             f"{world * L}")
        self = cls.__new__(cls)
        self.shape = {"s": S, "v": V}
        self.distributed = True
        owner = {divmod(f, V): f // L for f in range(S * V)}
        self._dev = {divmod(rank * L + i, V): d
                     for i, d in enumerate(devices)}
        # per axis: (process group, or None when this rank alone holds
        # them; the shards of this rank's exchange). The components are
        # rank-disjoint, so a rank is in one exchange an axis.
        self.exchanges = {}
        for a, axis in enumerate(AXES):
            for ranks, shards in _components((S, V), owner, a):
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    self.exchanges[axis] = (group, shards)
        return self

    @property
    def local(self) -> list:
        return list(self._dev)

    @property
    def devices(self) -> list:
        """The devices of the shards this process holds, in shard order."""
        return list(self._dev.values())

    @property
    def device(self) -> torch.device:
        return self._dev[self.local[0]]

    def device_of(self, coord) -> torch.device:
        return self._dev[coord]

    def _blocks(self, parts: dict, axis: str) -> dict:
        """{shard: block} for every shard whose block a sum or a gather
        over `axis` reads: in one process the parts themselves; across
        processes every shard of this rank's exchange, the others' through
        one `all_reduce` on `device` of a buffer in which each rank fills
        only its own shards' slots."""
        if not self.distributed:
            return parts
        group, shards = self.exchanges[axis]
        if group is None:
            return parts
        t = parts[self.local[0]]
        buf = torch.zeros((len(shards), *t.shape), dtype=t.dtype,
                          device=self.device)
        for i, c in enumerate(shards):
            if c in parts:
                buf[i] = parts[c]
        dist.all_reduce(buf, group=group)
        return dict(zip(shards, buf))

    def psum(self, parts: dict, axis: str) -> dict:
        """{coord: tensor} -> {coord: the sum over `axis` of the partials
        of coord's group}, added in shard order, on each shard's device."""
        a, k = AXES.index(axis), self.shape[axis]
        blocks = self._blocks(parts, axis)
        out, sums = {}, {}
        for coord in parts:
            head = _with(coord, a, 0)
            if head not in sums:
                sums[head] = ordered_sum(
                    [blocks[_with(coord, a, i)] for i in range(k)],
                    self._dev.get(head, self._dev[coord]))
            out[coord] = sums[head].to(self._dev[coord])
        return out

    def gather(self, parts: dict, axis: str, dim: int = 0) -> torch.Tensor:
        """Concatenate along `dim` the blocks of the shards along `axis`
        (the same on every shard of the other axis), on `device`, in every
        process."""
        a, k = AXES.index(axis), self.shape[axis]
        blocks, first = self._blocks(parts, axis), self.local[0]
        return torch.cat([blocks[_with(first, a, i)].to(self.device)
                          for i in range(k)], dim)


def default_devices(n_devices=None, device=None) -> list:
    """Every CUDA device when the device (`device`, else the configured
    one) is a CUDA device, else `n_devices` (1) shards on that device.
    With no card and no request for the CPU this raises, as every entry
    point does (`config.resolve_device`)."""
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * (n_devices or 1)


def make_mesh(n_devices: int | None = None, devices=None,
              device=None) -> Mesh:
    """A near-square (s, v) mesh in this process over `devices` (their
    first n_devices), by default every CUDA device (`default_devices`)."""
    devices = (default_devices(n_devices, device) if devices is None
               else [torch.device(d) for d in devices])
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"{n_devices} shards asked, {len(devices)} "
                             "devices given")
        devices = devices[:n_devices]
    s, v = factor_mesh(len(devices))
    return Mesh([devices[i * v:(i + 1) * v] for i in range(s)])


def shard_devices(mesh=None, device=None) -> list:
    """The flat shard list of a one-axis split: a Mesh's devices, a list
    of devices, or `default_devices(device=device)`. A mesh across
    processes raises: a one-axis split runs in one process."""
    if mesh is None:
        return default_devices(device=device)
    if isinstance(mesh, Mesh):
        if mesh.distributed:
            raise ValueError("a mesh across processes cannot split "
                             "LDpred2's chains or blocks: pass a Mesh of "
                             "this process or a list of devices")
        return mesh.devices
    return [torch.device(d) for d in mesh]


# ---------------------------------------------------------------------------
# global arrays on the mesh
# ---------------------------------------------------------------------------

class Sharded:
    """A global array on a mesh: parts[coord] is the block of shard coord,
    for the shards this process holds; spec[d] names the axis that splits
    dimension d ("s" or "v"), or None (whole on every shard)."""

    def __init__(self, mesh: Mesh, spec, shape, parts: dict):
        self.mesh, self.spec, self.shape = mesh, tuple(spec), tuple(shape)
        self.parts = parts

    def slices(self, coord) -> tuple:
        out = []
        for d, ax in enumerate(self.spec):
            if ax is None:
                out.append(slice(None))
                continue
            step = self.shape[d] // self.mesh.shape[ax]
            i = coord[AXES.index(ax)]
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)


def put_global(mesh: Mesh, arr, spec) -> Sharded:
    """Place a host array or a tensor on the mesh: each process takes only
    the blocks of its own shards."""
    t = arr if torch.is_tensor(arr) else torch.as_tensor(np.asarray(arr))
    for d, ax in enumerate(spec):
        if ax is not None and t.shape[d] % mesh.shape[ax]:
            raise ValueError(f"dimension {d} ({t.shape[d]}) does not split "
                             f"over the {mesh.shape[ax]} shards of {ax!r}")
    x = Sharded(mesh, spec, t.shape, {})
    x.parts = {c: t[x.slices(c)].to(mesh.device_of(c)).contiguous()
               for c in mesh.local}
    return x


def fetch_global(x: Sharded) -> np.ndarray:
    """The whole array on the host of every process. Across processes one
    `all_reduce` of the whole (zeros but the blocks of the shards that
    are first along the axes the array does not split) assembles it: for
    tall-skinny factors only, never the packed matrix."""
    mesh = x.mesh
    if not mesh.distributed:
        parts = {c: t.cpu().numpy() for c, t in x.parts.items()}
        dtype = next(iter(parts.values())).dtype
        full = np.empty(x.shape, dtype)
        for c, block in parts.items():
            full[x.slices(c)] = block
        return full
    t = x.parts[mesh.local[0]]
    full = torch.zeros(x.shape, dtype=t.dtype, device=mesh.device)
    whole = [a for a in AXES if a not in x.spec]
    for coord, t in x.parts.items():
        if all(coord[AXES.index(a)] == 0 for a in whole):
            full[x.slices(coord)] = t
    dist.all_reduce(full)
    return full.cpu().numpy()


def _na_tail(n: int):
    """(spare samples of the last byte, mask of its real bits, NA fill of
    the spare ones)."""
    n_rem = n % 4
    keep = (1 << (2 * n_rem)) - 1
    na_fill = sum(0b01 << (2 * k) for k in range(n_rem, 4))
    return n_rem, keep, na_fill


def load_block(read, n: int, m: int, nb: int, rows, cols,
               device) -> torch.Tensor:
    """Rows [r0, r1) x byte columns [c0, c1) of the padded packed matrix
    on `device`: bytes past (m, nb) are all-NA, and the spare bits of the
    last byte of a variant NA (a .bed pads them with zeros, which decode
    as dosage 2). read(r0, r1, c0, c1) gives the unpadded matrix's bytes
    there as a uint8 tensor, on any device."""
    (r0, r1), (c0, c1) = rows, cols
    out = torch.full((r1 - r0, c1 - c0), NA_BYTE, dtype=torch.uint8,
                     device=device)
    rr, cc = min(r1, m), min(c1, nb)
    if r0 < m and c0 < nb:
        out[:rr - r0, :cc - c0] = read(r0, rr, c0, cc).to(device)
        n_rem, keep, na_fill = _na_tail(n)
        if n_rem and c0 <= nb - 1 < cc:
            j = nb - 1 - c0
            out[:rr - r0, j] = (out[:rr - r0, j] & keep) | na_fill
    return out


def pad_sizes(mesh: Mesh, m: int, nb: int):
    """(m_pad, nb_pad): variants to a multiple of |v|, bytes of |s|."""
    S, V = mesh.shape["s"], mesh.shape["v"]
    return -(-m // V) * V, -(-nb // S) * S


def shard_tiles(mesh: Mesh, read, n: int, m: int, nb: int):
    """The tiles of the shards this process holds, each read by
    `load_block`: (Sharded (m_pad, nb_pad) spec ("v", "s"), n_pad)."""
    m_pad, nb_pad = pad_sizes(mesh, m, nb)
    m_loc, nb_loc = m_pad // mesh.shape["v"], nb_pad // mesh.shape["s"]
    parts = {}
    for (si, vi) in mesh.local:
        dev = mesh.device_of((si, vi))
        parts[(si, vi)] = load_block(
            lambda *a, dev=dev: read(*a, dev), n, m, nb,
            (vi * m_loc, (vi + 1) * m_loc), (si * nb_loc, (si + 1) * nb_loc),
            dev)
    return Sharded(mesh, ("v", "s"), (m_pad, nb_pad), parts), nb_pad * 4


def shard_pack(pack, mesh: Mesh):
    """Pad the packed genotype matrix and place it on the mesh: returns
    (packed (m_pad, nb_pad) spec ("v", "s"), n, m, n_pad). Samples pad
    to a multiple of 4 |s| with all-NA bytes (0b01010101), variants to a
    multiple of |v| with all-NA rows; the tail byte's spare bits become
    NA; tiles keep the true sample order. A tile comes from the pack's
    copy on its device when there is one, else from the host bytes."""
    m, nb = pack.packed.shape

    def read(r0, r1, c0, c1, dev):
        keys = [str(dev)]
        if dev.type == "cuda" and dev.index == torch.cuda.current_device():
            keys.append("cuda")
        for key in keys:
            if key in pack._device_cache:
                return pack._device_cache[key][r0:r1, c0:c1]
        return torch.from_numpy(np.array(pack.packed[r0:r1, c0:c1]))

    packed, n_pad = shard_tiles(mesh, read, pack.n, m, nb)
    return packed, pack.n, m, n_pad


# ---------------------------------------------------------------------------
# the sharded products: K1 / K2 on every tile, sums over the mesh
# ---------------------------------------------------------------------------

def _n_loc(packed: Sharded) -> int:
    return packed.shape[1] // packed.mesh.shape["s"] * 4


def _launch(mesh, packed, W, center, inv, prod):
    n_loc = _n_loc(packed)
    fn = geno_kernels.prod if prod else geno_kernels.cprod
    return {c: fn(packed.parts[c], n_loc, W.parts[c], center.parts[c],
                  inv.parts[c]) for c in mesh.local}


def _check_precision(precision):
    """The JAX package's three names are taken; each runs K1 / K2, whose
    products are exact and whose float32 sums are at least "highest"'s
    (the JAX package's Pallas kernels ignore the option too)."""
    config.check_precision(precision)


def cprod_fn(mesh: Mesh, precision="highest"):
    """(packed, V (n_pad, l) spec ("s", None), center, inv (m_pad,) spec
    ("v",)) -> X~ᵀV (m_pad, l) spec ("v", None): K1 on every tile, summed
    over "s". inv is 1/scale (0 for a variant of scale <= 0), where the
    JAX package's function takes the scale."""
    _check_precision(precision)

    def fn(packed, V, center, inv):
        B = mesh.psum(_launch(mesh, packed, V, center, inv, False), "s")
        return Sharded(mesh, ("v", None), (packed.shape[0], V.shape[1]), B)

    return fn


def prod_fn(mesh: Mesh, precision="highest"):
    """(packed, U (m_pad, l) spec ("v", None), center, inv) -> X~U (n_pad,
    l) spec ("s", None): K2 on every tile, summed over "v"."""
    _check_precision(precision)

    def fn(packed, U, center, inv):
        Y = mesh.psum(_launch(mesh, packed, U, center, inv, True), "v")
        return Sharded(mesh, ("s", None), (_n_loc(packed)
                                           * mesh.shape["s"], U.shape[1]), Y)

    return fn


def power_both_fn(mesh: Mesh, precision="highest"):
    """(packed, Q (n_pad, l) spec ("s", None), center, inv) -> (B = X~ᵀQ
    spec ("v", None), Y = X~B spec ("s", None)): K1, the sum over "s", K2,
    the sum over "v"; B never leaves the shards in between."""
    cprod, prod = cprod_fn(mesh, precision), prod_fn(mesh, precision)

    def fn(packed, Q, center, inv):
        B = cprod(packed, Q, center, inv)
        return B, prod(packed, B, center, inv)

    return fn


def power_iter_fn(mesh: Mesh, n_pad: int, precision="highest"):
    """(packed, Q, center, inv) -> Y = X~(X~ᵀQ) (n_pad, l) spec ("s",
    None)."""
    both = power_both_fn(mesh, precision)

    def fn(packed, Q, center, inv):
        if Q.shape[0] != n_pad:
            raise ValueError(f"Q has {Q.shape[0]} rows, the mesh {n_pad}")
        return both(packed, Q, center, inv)[1]

    return fn


class MeshOperator(geno_kernels.StdOperator):
    """The standardized genotype operator sharded over a mesh, with the
    surface {device, n, m, cprod, prod, power, power_dev} of
    `GenoOperator` (the multi-device path of randomSVD / autoSVD):
    samples over "s" (sums of K1 partials), variants over "v" (sums of K2
    partials). The results of cprod / prod / power reach every process.

    A variant whose scale is <= 0 contributes exactly 0 (inv = 0, center
    = 2), as in `GenoOperator` (port DEVIATIONS #5); the JAX package's
    MeshOperator gives it center 2 and scale 1."""

    def __init__(self, pack, center, scale, mesh: Mesh | None = None,
                 precision: str = "highest"):
        _check_precision(precision)
        self.mesh = mesh if mesh is not None else make_mesh()
        packed, n, m, n_pad = shard_pack(pack, self.mesh)
        self._finish(packed, n, m, n_pad, center, scale, precision)

    @classmethod
    def from_sharded(cls, packed: Sharded, n: int, m: int, n_pad: int,
                     center, scale, mesh: Mesh, precision: str = "highest"):
        """Build on tiles already placed, spec ("v", "s"): the
        multi-process path, where each rank read only its own tile
        (`parallel.distributed`)."""
        _check_precision(precision)
        self = cls.__new__(cls)
        self.mesh = mesh
        self._finish(packed, n, m, n_pad, center, scale, precision)
        return self

    def _finish(self, packed, n, m, n_pad, center, scale, precision):
        mesh = self.mesh
        self.packed, self.n, self.m, self.n_pad = packed, n, m, n_pad
        self.m_pad = packed.shape[0]
        self.device = mesh.device
        center = np.asarray(center, dtype=np.float64)
        scale = np.asarray(scale, dtype=np.float64)
        good = scale > 0
        inv = np.zeros(self.m_pad)
        inv[:m][good] = 1.0 / scale[good]
        ctr = np.full(self.m_pad, 2.0)
        ctr[:m] = np.where(good, center, 2.0)
        self.center = put_global(mesh, ctr.astype(np.float32), ("v",))
        self.inv = put_global(mesh, inv.astype(np.float32), ("v",))
        self._cprod = cprod_fn(mesh, precision)
        self._prod = prod_fn(mesh, precision)
        self._power = power_both_fn(mesh, precision)

    def _place(self, W, rows, rows_pad, axis):
        """W (rows, l) on `device` -> zero-padded to rows_pad, split over
        `axis`."""
        Wp = torch.zeros((rows_pad, W.shape[1]), dtype=torch.float32,
                         device=self.device)
        Wp[:rows] = W
        return put_global(self.mesh, Wp, (axis, None))

    def cprod_dev(self, V: torch.Tensor) -> torch.Tensor:
        """X~ᵀV on `device`: V (n, l) -> (m, l)."""
        B = self._cprod(self.packed, self._place(V, self.n, self.n_pad, "s"),
                        self.center, self.inv)
        return self.mesh.gather(B.parts, "v")[:self.m]

    def prod_dev(self, U: torch.Tensor) -> torch.Tensor:
        """X~U on `device`: U (m, l) -> (n, l)."""
        Y = self._prod(self.packed, self._place(U, self.m, self.m_pad, "v"),
                       self.center, self.inv)
        return self.mesh.gather(Y.parts, "s")[:self.n]

    def power_dev(self, V: torch.Tensor):
        """One Krylov step on the mesh, V (n, l) -> (B = X~ᵀV (m, l), Y =
        X~B (n, l)) on `device`: K1, the sum over "s", K2, the sum over
        "v"; the pad rows are all-NA (decode to 0), so the padded operator
        has the same non-zero spectrum."""
        B, Y = self._power(self.packed,
                           self._place(V, self.n, self.n_pad, "s"),
                           self.center, self.inv)
        return (self.mesh.gather(B.parts, "v")[:self.m],
                self.mesh.gather(Y.parts, "s")[:self.n])


# ---------------------------------------------------------------------------
# per-variant statistics and pair sums with the sample axis sharded
# ---------------------------------------------------------------------------

def tile_colstats(tile: torch.Tensor, n_loc: int) -> torch.Tensor:
    """(3, rows) int64 (sum, sum of squares, non-missing count) of the
    dosages of one tile, NA (and the pad samples) left out."""
    rows = tile.shape[0]
    out = torch.empty((3, rows), dtype=torch.int64, device=tile.device)
    block = 4 * pick_block(n_loc)
    for b0 in range(0, rows, block):
        codes = unpack_codes(tile[b0:b0 + block], n_loc)
        c1 = (codes == 2).sum(1)          # dosage 1
        c2 = (codes == 0).sum(1)          # dosage 2
        out[0, b0:b0 + block] = c1 + 2 * c2
        out[1, b0:b0 + block] = c1 + 4 * c2
        out[2, b0:b0 + block] = n_loc - (codes == 1).sum(1)
    return out


def colstats_fn(mesh: Mesh):
    """packed (spec ("v", "s")) -> (3, m_pad) int64 numpy: per-variant
    (sum, ssq, nona) of the dosages, exact, summed over "s", on every
    process (the JAX package's float32 sums of the same integers)."""

    def fn(packed: Sharded) -> np.ndarray:
        n_loc = _n_loc(packed)
        parts = {c: tile_colstats(packed.parts[c], n_loc)
                 for c in mesh.local}
        return mesh.gather(mesh.psum(parts, "s"), "v", dim=1).cpu().numpy()

    return fn


def pair_sums_fn(mesh: Mesh, precision="highest"):
    """(targets (B, nbytes), band (Wb, nbytes)), both spec (None, "s") ->
    the (3B, 3Wb) int64 Gram of the stacked planes [x, x^2, mask] of
    snp_cor's NA-aware pair sums, each shard's exact integer sums
    (`ops.corr.pair_gram`) added over "s", on `mesh.device`. The caller
    NA-pads the tail and pad bytes, as for the JAX package's function."""
    _check_precision(precision)

    def fn(targets: Sharded, band: Sharded) -> torch.Tensor:
        parts = {c: pair_gram(targets.parts[c], band.parts[c],
                              4 * targets.parts[c].shape[1])
                 for c in mesh.local}
        return mesh.psum(parts, "s")[mesh.local[0]].to(mesh.device)

    return fn
