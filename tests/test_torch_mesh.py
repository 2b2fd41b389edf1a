"""Port parity: the device mesh (`bigsnpr_tpu_torch/parallel/mesh.py`)
against the JAX package's `parallel/mesh.py` on conftest's 8-device CPU
mesh, with the same numpy inputs: the mesh's factors and padded bytes,
colstats, the pair sums of snp_cor, the sharded products and the
MeshOperator, randomSVD's "mesh" and "mesh-device" engines and autoSVD
on them, and 8 / 2 / 1-shard invariance. The port's shards are 8, 2 or 1
CPU "devices" in one process. The packs have no monomorphic variant (a
scale-0 variant takes another rule in each package, port DEVIATIONS #5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import bigsnpr_tpu as bt
from bigsnpr_tpu.parallel import mesh as jmesh
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.ops import geno_kernels
from bigsnpr_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)
SHARDS = (8, 2, 1)
needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def packs(n, m, seed, na_prob=0.05):
    """The same snp_fake pack in both packages (same numpy stream)."""
    jp = bt.snp_fake(n, m, seed=seed, na_prob=na_prob)
    pp = pt.snp_fake(n, m, seed=seed, na_prob=na_prob)
    np.testing.assert_array_equal(pp.packed, np.asarray(jp.packed))
    sc = pt.bed_scaleBinom(pp)
    assert (sc["scale"] > 0).all(), "a monomorphic variant"
    return jp, pp, sc


def dense(pp, sc):
    D = pp.to_dosage()
    return np.where(np.isnan(D), 0.0, (D - sc["center"]) / sc["scale"])


def test_factor_mesh_matches_jax():
    for nd in range(1, 33):
        assert pmesh.factor_mesh(nd) == jmesh.factor_mesh(nd)
    for nd in SHARDS:
        mesh = pmesh.make_mesh(nd)
        assert (mesh.shape["s"], mesh.shape["v"]) == jmesh.factor_mesh(nd)
        assert mesh.devices == [torch.device("cpu")] * nd
    with pytest.raises(ValueError, match="3 devices given"):
        pmesh.make_mesh(4, devices=["cpu"] * 3)


@needs_8
@pytest.mark.parametrize("nd", SHARDS)
@pytest.mark.parametrize("n", [101, 102, 103, 104])
def test_shard_pack_bytes_match_jax(nd, n):
    jp, pp, _ = packs(n, 37, seed=n)
    jarr, jn, jm, jn_pad = jmesh.shard_pack(jp, jmesh.make_mesh(nd))
    mesh = pmesh.make_mesh(nd)
    arr, pn, m_, n_pad = pmesh.shard_pack(pp, mesh)
    assert (pn, m_, n_pad) == (jn, jm, jn_pad)
    full = pmesh.fetch_global(arr)
    np.testing.assert_array_equal(full, np.asarray(jarr))
    # tiles in true sample order: the tile of (si, vi) is its block
    for c, t in arr.parts.items():
        np.testing.assert_array_equal(t.numpy(), full[arr.slices(c)])


@needs_8
def test_colstats_match_jax_and_numpy():
    jp, pp, _ = packs(90, 41, seed=22, na_prob=0.1)
    X = pp.to_dosage()
    outs = []
    for nd in SHARDS:
        mesh = pmesh.make_mesh(nd)
        packed = pmesh.shard_pack(pp, mesh)[0]
        got = pmesh.colstats_fn(mesh)(packed)[:, :41]
        jm = jmesh.make_mesh(nd)
        ref = np.asarray(jmesh.colstats_fn(jm)(jmesh.shard_pack(jp, jm)[0]))
        np.testing.assert_array_equal(got, ref[:, :41])
        outs.append(got)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_array_equal(outs[0][0], np.nansum(X, 0))
    np.testing.assert_array_equal(outs[0][1], np.nansum(X * X, 0))
    np.testing.assert_array_equal(outs[0][2], (~np.isnan(X)).sum(0))


@needs_8
def test_pair_sums_bit_equal_to_jax():
    jp, pp, _ = packs(203, 30, seed=5, na_prob=0.08)
    for nd in SHARDS:
        mesh, jm = pmesh.make_mesh(nd), jmesh.make_mesh(nd)
        full = pmesh.fetch_global(pmesh.shard_pack(pp, mesh)[0])
        t, b = full[:7], full[5:30]      # NA-padded tail and pad bytes
        got = pmesh.pair_sums_fn(mesh)(pmesh.put_global(mesh, t, (None, "s")),
                                       pmesh.put_global(mesh, b, (None, "s")))
        spec = NamedSharding(jm, P(None, "s"))
        ref = jmesh.pair_sums_fn(jm)(jax.device_put(jnp.asarray(t), spec),
                                     jax.device_put(jnp.asarray(b), spec))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@needs_8
@pytest.mark.parametrize("nd", SHARDS)
def test_mesh_operator_matches_jax(nd):
    jp, pp, sc = packs(103, 57, seed=21, na_prob=0.06)
    Xt = dense(pp, sc)
    rng = np.random.default_rng(nd)
    V = rng.standard_normal((103, 4)).astype(np.float32)
    U = rng.standard_normal((57, 4)).astype(np.float32)
    op = pmesh.MeshOperator(pp, sc["center"], sc["scale"],
                            mesh=pmesh.make_mesh(nd))
    jop = jmesh.MeshOperator(jp, sc["center"], sc["scale"],
                             mesh=jmesh.make_mesh(nd))
    B, Y = op.cprod(V), op.prod(U)
    for got, ref, exact in ((B, jop.cprod(V), Xt.T @ V),
                            (Y, jop.prod(U), Xt @ U)):
        scale = np.abs(exact).max()
        np.testing.assert_allclose(got, ref, atol=2e-6 * scale, rtol=0)
        np.testing.assert_allclose(got, exact, atol=2e-6 * scale, rtol=0)
    Bp, Yp = op.power(V)
    np.testing.assert_array_equal(Bp, B)
    np.testing.assert_array_equal(Yp, op.prod(B))
    jB, jY = jop.power(V)
    np.testing.assert_allclose(Yp, jY, atol=2e-6 * np.abs(jY).max(), rtol=0)
    # 1-D operands squeeze, as the JAX operator's
    assert op.cprod(V[:, 0]).shape == (57,) and op.prod(U[:, 0]).shape == (
        103,)
    # the same operator as the single-device GenoOperator
    g = pt.GenoOperator(pp, sc["center"], sc["scale"])
    np.testing.assert_allclose(B, g.cprod(V), atol=1e-6 * np.abs(B).max(),
                               rtol=0)


def test_shard_invariance_and_functions():
    """8 / 2 / 1 shards agree (the reference's ncores = 1 vs 2 suite,
    tests/testthat/test-7-OpenMP.R, on the mesh), and the functional forms
    give the operator's products."""
    _, pp, sc = packs(203, 131, seed=9, na_prob=0.03)
    rng = np.random.default_rng(0)
    V = rng.standard_normal((203, 5)).astype(np.float32)
    outs = [pmesh.MeshOperator(pp, sc["center"], sc["scale"],
                               mesh=pmesh.make_mesh(nd)).power(V)
            for nd in SHARDS]
    for B, Y in outs[1:]:
        np.testing.assert_allclose(B, outs[0][0], rtol=0,
                                   atol=2e-6 * np.abs(B).max())
        np.testing.assert_allclose(Y, outs[0][1], rtol=0,
                                   atol=2e-6 * np.abs(Y).max())
    mesh = pmesh.make_mesh(8)
    op = pmesh.MeshOperator(pp, sc["center"], sc["scale"], mesh=mesh)
    Vp = np.zeros((op.n_pad, 5), np.float32)
    Vp[:203] = V
    Q = pmesh.put_global(mesh, Vp, ("s", None))
    Y = pmesh.power_iter_fn(mesh, op.n_pad)(op.packed, Q, op.center, op.inv)
    np.testing.assert_array_equal(pmesh.fetch_global(Y)[:203], outs[0][1])
    # the JAX package's three names run K1 / K2 alike; another raises
    for name in ("default", "high"):
        got = pmesh.MeshOperator(pp, sc["center"], sc["scale"], mesh=mesh,
                                 precision=name).power(V)
        np.testing.assert_array_equal(got[0], op.power(V)[0])
        np.testing.assert_array_equal(got[1], op.power(V)[1])
    with pytest.raises(ValueError, match="precision"):
        pmesh.MeshOperator(pp, sc["center"], sc["scale"], mesh=mesh,
                           precision="bf16")


def test_tiles_launch_k1_k2_per_tile(monkeypatch):
    """Each shard runs K1 / K2 (their CPU twins here) on its own tile,
    with its own n_loc: the wrappers are called once a tile a product."""
    _, pp, sc = packs(103, 57, seed=21)
    calls = []
    for name in ("cprod", "prod"):
        real = getattr(geno_kernels, name)

        def spy(packed, n, W, c, inv, real=real, name=name):
            calls.append((name, tuple(packed.shape), n))
            return real(packed, n, W, c, inv)
        monkeypatch.setattr(geno_kernels, name, spy)
    op = pmesh.MeshOperator(pp, sc["center"], sc["scale"],
                            mesh=pmesh.make_mesh(8))
    op.power(np.ones((103, 2), np.float32))
    # 2 x 4 mesh: 104 samples in 26 bytes -> 13 a tile; 57 -> 60 variants
    assert calls == [("cprod", (15, 13), 52)] * 8 + [("prod", (15, 13), 52)] * 8


@needs_8
@pytest.mark.parametrize("engine", ["mesh", "mesh-device"])
def test_random_svd_mesh_engines_match_jax(engine):
    jp, pp, sc = packs(256, 512, seed=4, na_prob=0.02)
    ref = bt.snp_randomSVD(jp, k=5, tol=1e-7, engine="mesh")
    got = pt.snp_randomSVD(pp, k=5, tol=1e-7, engine=engine,
                           mesh=pmesh.make_mesh(8))
    np.testing.assert_allclose(got.d, ref.d, rtol=1e-4)
    cos = np.abs(np.sum(got.u * ref.u, axis=0))
    assert cos.min() > 0.999, cos
    d_ref = np.linalg.svd(dense(pp, sc), compute_uv=False)[:5]
    np.testing.assert_allclose(got.d, d_ref, rtol=1e-4)
    # the physical subset, as the JAX package's mesh engine builds it
    rows, cols = np.arange(0, 256, 2), np.arange(1, 512, 3)
    sub = pt.snp_randomSVD(pp, k=3, tol=1e-7, engine=engine,
                           ind_row=rows, ind_col=cols,
                           mesh=pmesh.make_mesh(2))
    jsub = bt.snp_randomSVD(jp, k=3, tol=1e-7, engine="mesh", ind_row=rows,
                            ind_col=cols)
    np.testing.assert_allclose(sub.d, jsub.d, rtol=1e-4)
    assert sub.u.shape == (128, 3) and sub.v.shape == (len(cols), 3)


def test_random_svd_mesh_engine_refuses_dosages():
    """A DosagePack under "mesh" runs unsharded on one device, as the JAX
    package runs it (port DEVIATIONS #4; it raised before): the same
    result as under "auto". An unknown engine raises."""
    pack = pt.snp_fake(40, 30, seed=1)
    codes = np.nan_to_num(pack.to_dosage().T, nan=3).astype(np.uint8)
    dpack = pt.DosagePack(codes=codes, n=40)
    with pytest.raises(ValueError, match="engine"):
        pt.snp_randomSVD(pack, k=2, engine="nope")
    ref = pt.snp_randomSVD(dpack, k=2)
    assert ref.d.shape == (2,)
    for engine in ("mesh", "mesh-device"):
        got = pt.snp_randomSVD(dpack, k=2, engine=engine)
        np.testing.assert_array_equal(got.d, ref.d)


@needs_8
def test_autosvd_mesh_engine_gives_jax_subset():
    jp, pp, _ = packs(300, 600, seed=11, na_prob=0.0)
    pos = np.arange(600) * 1000.0
    chrs = np.ones(600, dtype=int)
    kw = dict(infos_chr=chrs, infos_pos=pos, k=4, thr_r2=0.5, max_iter=2)
    ref = bt.snp_autoSVD(jp, svd_kwargs={"engine": "mesh", "tol": 1e-7},
                         **kw)
    got = pt.snp_autoSVD(pp, svd_kwargs={"engine": "mesh", "tol": 1e-7,
                                         "mesh": pmesh.make_mesh(8)}, **kw)
    np.testing.assert_array_equal(got.subset, ref.subset)
    np.testing.assert_allclose(got.d, ref.d, rtol=1e-4)
    cos = np.abs(np.sum(ref.u * got.u, axis=0))
    assert cos.min() > 0.999, cos


def test_auto_takes_the_mesh_on_several_cards(monkeypatch):
    """The JAX package's rule for engine "auto" (the mesh when it runs
    with more than one device), on CUDA: a bare "cuda" with two cards
    takes the mesh; one card, a named card or the CPU keep one device."""
    from bigsnpr_tpu_torch.linalg import randomsvd

    for count, device, want in ((2, "cuda", True), (8, "cuda", True),
                                (1, "cuda", False), (2, "cuda:1", False),
                                (2, "cuda:0", False), (2, "cpu", False)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert randomsvd.auto_takes_mesh(torch.device(device)) is want, (
            count, device)


def test_auto_on_the_mesh_is_mesh_device(monkeypatch):
    """"auto", steered onto a 2-shard CPU mesh by the rule, gives the same
    bits as engine="mesh-device" on that mesh, with a row and a column
    subset; with the rule off it runs the single-device GenoOperator."""
    from bigsnpr_tpu_torch.linalg import randomsvd

    _, pp, _ = packs(203, 131, seed=9, na_prob=0.03)
    mesh = pmesh.make_mesh(2)
    rows, cols = np.arange(0, 203, 2), np.arange(1, 131, 2)
    kw = dict(k=4, tol=1e-7, mesh=mesh, ind_row=rows, ind_col=cols)
    ref = pt.snp_randomSVD(pp, engine="mesh-device", **kw)
    built = []
    real = randomsvd.MeshOperator

    def spy(*a, **k):
        built.append(k["mesh"])
        return real(*a, **k)

    monkeypatch.setattr(randomsvd, "MeshOperator", spy)
    monkeypatch.setattr(randomsvd, "auto_takes_mesh", lambda dev: True)
    got = pt.snp_randomSVD(pp, engine="auto", **kw)
    assert built == [mesh]
    for key in ("d", "u", "v", "center", "scale", "niter"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key),
                                      err_msg=key)
    monkeypatch.setattr(randomsvd, "auto_takes_mesh", lambda dev: False)
    one = pt.snp_randomSVD(pp, engine="auto", **kw)
    assert built == [mesh]
    assert any(type(op) is pt.GenoOperator
               for op in pp._op_cache.values())
    np.testing.assert_allclose(one.d, ref.d, rtol=1e-5)


def test_auto_keeps_a_dosage_pack_on_one_device(monkeypatch):
    """A DosagePack under "auto" runs on DosageOperator whatever the rule
    says (the JAX package runs it unsharded), never on the mesh."""
    from bigsnpr_tpu_torch.linalg import randomsvd

    pack = pt.snp_fake(60, 40, seed=3)
    codes = np.nan_to_num(pack.to_dosage().T, nan=3).astype(np.uint8)
    dpack = pt.DosagePack(codes=codes, n=60)
    built = []
    real = randomsvd.DosageOperator

    def spy(*a, **k):
        built.append(True)
        return real(*a, **k)

    def no_mesh(*a, **k):
        raise AssertionError("a DosagePack reached the mesh")

    monkeypatch.setattr(randomsvd, "DosageOperator", spy)
    monkeypatch.setattr(randomsvd, "MeshOperator", no_mesh)
    monkeypatch.setattr(randomsvd, "auto_takes_mesh", lambda dev: True)
    svd = pt.snp_randomSVD(dpack, k=2)
    assert built == [True] and svd.d.shape == (2,)


def test_one_axis_split_refuses_a_mesh_across_processes():
    """LDpred2's shard_chains / shard_blocks split over the shards of one
    process: a mesh across processes raises, where taking its local
    shards alone would run the chains of this rank only."""
    mesh = pmesh.make_mesh(2)
    assert pmesh.shard_devices(mesh) == [torch.device("cpu")] * 2
    mesh.distributed = True
    with pytest.raises(ValueError, match="across processes"):
        pmesh.shard_devices(mesh)
