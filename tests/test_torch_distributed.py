"""Port parity: the multi-process layer (`bigsnpr_tpu_torch/parallel/
distributed.py`) against the JAX package's: `shard_slice` on the cases of
tests/test_distributed.py, `bed_shard_bytes` on a .bed this test writes,
the per-rank ingest in one process, and a real two-process run on gloo
(one subprocess a rank, a file store, jax and the JAX package blocked in
the ranks, one or two shards a rank) whose ranks must agree bit for bit,
with each other and with the in-process mesh of the same shape, and
match the JAX package's single-process MeshOperator and a dense float64
oracle."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.parallel import distributed as jdist
from bigsnpr_tpu.parallel import mesh as jmesh
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.parallel import distributed as pdist
from bigsnpr_tpu_torch.parallel import mesh as pmesh
from bigsnpr_tpu_torch.parallel import selfcheck

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV2 = {**os.environ, "OMP_NUM_THREADS": "2"}

# a rank with jax, jaxlib, pandas and the JAX package blocked, as in
# tests/test_torch_slice.py: a finder that raises
RANK = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "bigsnpr_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])
    from bigsnpr_tpu_torch.parallel import selfcheck
    selfcheck.main(sys.argv[2:])
    bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not bad, bad
""")

# the in-process mesh of the same shape on the same tiles, in a process of
# the ranks' environment: the host LAPACK that turns the Krylov Gram into
# d rounds its last bit by its thread count
ONE_PROCESS = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from bigsnpr_tpu_torch import config
    from bigsnpr_tpu_torch.parallel import distributed as pdist
    from bigsnpr_tpu_torch.parallel import mesh as pmesh
    from bigsnpr_tpu_torch.parallel import selfcheck
    torch.set_num_threads(2)
    config.set_device("cpu")
    S, V = int(sys.argv[4]), int(sys.argv[5])
    mesh = pmesh.Mesh([["cpu"] * V] * S)
    np.savez(sys.argv[3], **selfcheck.products(
        *pdist.distributed_binom_operator(sys.argv[2], mesh)))
""")


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


@pytest.fixture(scope="module")
def bed(tmp_path_factory):
    """517 samples (a partial last byte) x 400 variants, 4% NA, none
    monomorphic."""
    pack = pt.snp_fake(517, 400, seed=7, na_prob=0.04)
    assert (pt.bed_scaleBinom(pack, device="cpu")["scale"] > 0).all()
    return pt.snp_writeBed(pack, tmp_path_factory.mktemp("bed") / "c.bed")


def oracle(bed):
    pack = pt.snp_readBed(bed)
    sc = pt.bed_scaleBinom(pack)
    D = pack.to_dosage()
    Xt = np.where(np.isnan(D), 0.0, (D - sc["center"]) / sc["scale"])
    return pack, sc, Xt


def test_shard_slice_matches_jax():
    for total, nproc, q in [(130, 2, 1), (517, 3, 4), (7, 4, 1), (5, 8, 1),
                            (130, 1, 1), (0, 3, 4)]:
        for p in range(nproc):
            assert (pdist.shard_slice(total, p, nproc, quantum=q)
                    == jdist.shard_slice(total, p, nproc, quantum=q))


def test_bed_shard_bytes_roundtrip(bed):
    full = np.asarray(pt.snp_readBed(bed).packed)
    parts = [pdist.bed_shard_bytes(bed, p, 3) for p in range(3)]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts], 1),
                                  full)
    assert all(p[1:4] == (517, 400, full.shape[1]) for p in parts)
    assert [p[4] for p in parts] == [0, 44, 88]
    for p, ref in zip(parts, (jdist.bed_shard_bytes(bed, q, 3)
                              for q in range(3))):
        np.testing.assert_array_equal(p[0], ref[0])


@pytest.mark.parametrize("nd", [8, 2])
def test_ingest_in_one_process(bed, nd):
    """shard_pack_distributed (each shard reads its own bytes) on an
    in-process mesh gives shard_pack's tiles, the JAX package's bytes,
    and distributed_binom_operator gives bed_scaleBinom's scaling."""
    mesh = pmesh.make_mesh(nd)
    packed, n, m, n_pad = pdist.shard_pack_distributed(bed, mesh)
    ref = pmesh.shard_pack(pt.snp_readBed(bed), mesh)
    assert (n, m, n_pad) == ref[1:]
    for c in mesh.local:
        np.testing.assert_array_equal(packed.parts[c].numpy(),
                                      ref[0].parts[c].numpy())
    local = pdist.host_local_shard(mesh, {c: t.numpy() for c, t in
                                          packed.parts.items()})
    assert local.shape == packed.shape and local.spec == ("v", "s")
    np.testing.assert_array_equal(pmesh.fetch_global(local),
                                  pmesh.fetch_global(packed))
    jarr = jmesh.shard_pack(bt.snp_readBed(bed), jmesh.make_mesh(nd))[0]
    np.testing.assert_array_equal(pmesh.fetch_global(packed),
                                  np.asarray(jarr))
    op, sc = pdist.distributed_binom_operator(bed, mesh)
    pack, sc0, Xt = oracle(bed)
    np.testing.assert_array_equal(sc["center"], sc0["center"])
    np.testing.assert_array_equal(sc["scale"], sc0["scale"])
    V = np.random.default_rng(0).standard_normal((517, 3)).astype(np.float32)
    B = op.cprod(V)
    np.testing.assert_allclose(B, Xt.T @ V, rtol=0,
                               atol=2e-6 * np.abs(Xt.T @ V).max())
    assert pdist.init_distributed(None, 1, 0) is False


@pytest.mark.parametrize("shape,L,exchanges", [
    # (s, v), shards a rank, {axis: [(ranks, shards) of each exchange]}
    ((2, 1), 1, {"s": [([0, 1], [(0, 0), (1, 0)])],
                 "v": [([0], [(0, 0)]), ([1], [(1, 0)])]}),
    ((2, 2), 2, {"s": [([0, 1], [(0, 0), (0, 1), (1, 0), (1, 1)])],
                 "v": [([0], [(0, 0), (0, 1)]), ([1], [(1, 0), (1, 1)])]}),
    ((1, 4), 2, {"s": [([0], [(0, 0), (0, 1)]), ([1], [(0, 2), (0, 3)])],
                 "v": [([0, 1], [(0, 0), (0, 1), (0, 2), (0, 3)])]}),
    # rank 1 holds (0, 2) and (1, 0): the two rows' groups overlap in it,
    # so the whole world exchanges for the sum over "v"
    ((2, 3), 2, {"s": [([0, 1, 2], [(0, 0), (0, 1), (0, 2), (1, 0),
                                    (1, 1), (1, 2)])],
                 "v": [([0, 1, 2], [(0, 0), (0, 1), (0, 2), (1, 0),
                                    (1, 1), (1, 2)])]})])
def test_exchange_components(shape, L, exchanges):
    """The ranks that exchange for a sum over each axis: the ranks of
    every axis group linked by a shared rank, with every shard of those
    groups, so every rank is in one exchange an axis; a rank alone does
    not communicate."""
    S, V = shape
    owner = {divmod(f, V): f // L for f in range(S * V)}
    for a, axis in enumerate(pmesh.AXES):
        got = pmesh._components(shape, owner, a)
        assert got == exchanges[axis], (axis, got)
        ranks = sorted(r for comp, _ in got for r in comp)
        assert ranks == list(range(S * V // L))


def test_rank_devices(monkeypatch):
    """A rank's devices: a named card or the CPU alone; a bare "cuda"
    split evenly over the ranks of the host (torchrun's one card a rank,
    or every card for one process a host); more ranks than cards share
    them; an uneven split raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    cuda = [torch.device("cuda", i) for i in range(8)]
    assert pdist.rank_devices("cpu") == [torch.device("cpu")]
    assert pdist.rank_devices("cuda:1") == [cuda[1]]
    assert pdist.rank_devices("cuda") == cuda
    for world, rank, want in ((8, 3, cuda[3:4]), (2, 1, cuda[4:]),
                              (1, 0, cuda), (16, 11, cuda[3:4])):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(world))
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        assert pdist.rank_devices("cuda") == want, (world, rank)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="split evenly"):
        pdist.rank_devices("cuda")


def coords_of(shape, L, rank):
    """The shards of a rank in the JAX package's layout: r * L ... r * L +
    L - 1 of the row-major (s, v) grid."""
    return {divmod(rank * L + i, shape[1]) for i in range(L)}


def run_ranks(bed, tmp_path, world, shape, L):
    """`world` gloo ranks of L shards each (the ranks blocked from jax)
    and, for L > 1, the in-process mesh of the same shape beside them;
    holds the ranks' shards and bits. Returns rank 0's results."""
    one = tmp_path / "one_process.npz"
    ref = (subprocess.Popen([sys.executable, "-c", ONE_PROCESS, REPO,
                             str(bed), str(one), *map(str, shape)], env=ENV2)
           if L > 1 else None)
    try:
        res = selfcheck.spawn(world, bed, tmp_path / "ranks", backend="gloo",
                              device="cpu", shape=shape, shards_per_rank=L,
                              timeout=120, prefix=[sys.executable, "-c",
                                                   RANK, REPO], env=ENV2)
    finally:
        if ref is not None and ref.wait(timeout=120):
            raise RuntimeError("the one-process reference failed")
    r0 = res[0]
    assert int(r0["world"]) == world and str(r0["backend"]) == "gloo"
    assert tuple(r0["mesh"]) == shape
    for r, got in enumerate(res):
        assert {tuple(c) for c in got["coords"]} == coords_of(shape, L, r)
        assert len(got["coords"]) == L
    for got in res[1:]:
        for key in selfcheck.KEYS:
            np.testing.assert_array_equal(r0[key], got[key], err_msg=key)
    if L > 1:
        here = np.load(one)
        for key in selfcheck.KEYS:
            np.testing.assert_array_equal(r0[key], here[key], err_msg=key)
    return r0


@pytest.mark.parametrize("shape,L", [
    pytest.param((2, 1), 1, id="shape0"),
    pytest.param((1, 2), 1, id="shape1"),
    pytest.param((2, 2), 2, id="shape2x2-2_shards_a_rank"),
    pytest.param((1, 4), 2, id="shape1x4-2_shards_a_rank")])
def test_two_process_gloo(bed, tmp_path, shape, L):
    """Two ranks on gloo, each holding L tiles (L = 1: one tile of a (2, 1)
    mesh, its own sample bytes, or of a (1, 2) mesh, its own variants; L =
    2: two tiles of a (2, 2) or a (1, 4) mesh, rank r the shards 2r, 2r +
    1 in row-major order, the JAX package's layout): every output
    bit-equal across the ranks and, for L = 2, to the in-process mesh of
    the same shape on the same tiles, the scaling equal to
    bed_scaleBinom's to 1e-12, the products within 2e-4 of max of the JAX
    package's single-process MeshOperator and of float64, d against a
    dense SVD."""
    r0 = run_ranks(bed, tmp_path, 2, shape, L)
    pack, sc, Xt = oracle(bed)
    np.testing.assert_allclose(r0["center"], sc["center"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r0["scale"], sc["scale"], rtol=0, atol=1e-12)
    # fetch_global: each variant block once, from the shards of row s = 0
    center = r0["center_mesh"]
    assert len(center) % shape[1] == 0 and (center[pack.m:] == 2).all()
    np.testing.assert_array_equal(center[:pack.m],
                                  sc["center"].astype(np.float32))
    rng = np.random.default_rng(0)
    V = rng.standard_normal((pack.n, 3)).astype(np.float32)
    U = rng.standard_normal((pack.m, 3)).astype(np.float32)
    jop = jmesh.MeshOperator(bt.snp_readBed(bed), sc["center"], sc["scale"])
    for got, ref, exact in ((r0["B"], jop.cprod(V), Xt.T @ V),
                            (r0["Y"], jop.prod(U), Xt @ U)):
        scale = np.abs(exact).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * scale)
        np.testing.assert_allclose(got, exact, rtol=0, atol=2e-4 * scale)
    np.testing.assert_array_equal(r0["Bp"], r0["B"])
    d_ref = np.linalg.svd(Xt, compute_uv=False)[:5]
    np.testing.assert_allclose(r0["d"], d_ref, rtol=1e-4)


def test_three_ranks_whose_rows_overlap(bed, tmp_path):
    """Three ranks of two shards on a (2, 3) mesh: rank 1 holds (0, 2) and
    (1, 0), so the two rows' groups share it and the sum over "v" is one
    exchange of the whole world (`test_exchange_components`). The ranks
    are bit-equal to each other and to the in-process mesh, the products
    within 2e-4 of max of float64."""
    r0 = run_ranks(bed, tmp_path, 3, (2, 3), 2)
    pack, sc, Xt = oracle(bed)
    rng = np.random.default_rng(0)
    V = rng.standard_normal((pack.n, 3)).astype(np.float32)
    U = rng.standard_normal((pack.m, 3)).astype(np.float32)
    for got, exact in ((r0["B"], Xt.T @ V), (r0["Y"], Xt @ U)):
        np.testing.assert_allclose(got, exact, rtol=0,
                                   atol=2e-4 * np.abs(exact).max())
