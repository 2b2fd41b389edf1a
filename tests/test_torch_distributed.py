"""Port parity: the multi-process layer (`bigsnpr_tpu_torch/parallel/
distributed.py`) against the JAX package's: `shard_slice` on the cases of
tests/test_distributed.py, `bed_shard_bytes` on a .bed this test writes,
the per-rank ingest in one process, and a real two-process run on gloo
(one subprocess a rank, a file store, jax and the JAX package blocked in
the ranks) whose ranks must agree bit for bit and match the JAX package's
single-process MeshOperator and a dense float64 oracle."""

import os
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


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_two_process_gloo(bed, tmp_path, shape):
    """Two ranks on gloo, each holding one tile of a (2, 1) mesh (its own
    sample bytes) or of a (1, 2) mesh (its own variants): every output
    bit-equal across the ranks, the scaling equal to bed_scaleBinom's to
    1e-12, the products within 2e-4 of max of the JAX package's
    single-process MeshOperator and of float64, d against a dense SVD."""
    res = selfcheck.spawn(2, bed, tmp_path, backend="gloo", device="cpu",
                          shape=shape, timeout=120,
                          prefix=[sys.executable, "-c", RANK, REPO], env=ENV2)
    r0, r1 = res
    assert int(r0["world"]) == 2 and str(r0["backend"]) == "gloo"
    assert tuple(r0["mesh"]) == shape
    assert {tuple(r0["coord"]), tuple(r1["coord"])} == (
        {(0, 0), (1, 0)} if shape == (2, 1) else {(0, 0), (0, 1)})
    for key in ("B", "Y", "Bp", "Yp", "d", "u", "v", "center", "scale",
                "niter"):
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)

    pack, sc, Xt = oracle(bed)
    np.testing.assert_allclose(r0["center"], sc["center"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r0["scale"], sc["scale"], rtol=0, atol=1e-12)
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
