"""The port's BGEN reader (`io/bgen.py`, the native decode in
`native/io_native.cpp`) against the JAX package's on a BGEN v1.2 layout-2
zlib file and its .bgi written by chip_smoke.write_bgen (the reference's
fixtures are not mounted, so tests/test_bgen.py skips here).

The JAX oracle's native library is built privately for this process
(tests/oracle_native.py), so its snp_readBGEN runs its native decode and
not its Python fallback. Tolerances: .bgi rows, dosage codes and random
hard calls bit-equal; freq / INFO 1e-12; snp_prodBGEN's host engine 1e-12
of max |JAX host|, its device engine rtol = atol = 5e-6 of the JAX host
engine (tests/test_bgen.py:181-196's bound)."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from bigsnpr_tpu.core.dosage import DosagePack as JaxDosagePack
from bigsnpr_tpu.io import bgen as jbgen
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.io import bgen as pbgen
from bigsnpr_tpu_torch.ops import cuda_build

from oracle_native import private_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the repository's one BGEN writer)

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    yield from private_native(tmp_path_factory)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def probabilities(rng, m, N):
    """8-bit pairs of imputed-like genotypes: 60% of the variants certain,
    the rest mixed with an HWE prior; 4% missing."""
    x = rng.integers(0, 3, (m, N))
    w = np.where(rng.random(m) < 0.6, 1.0, rng.uniform(0.2, 0.9, m))[:, None]
    f = rng.uniform(0.1, 0.5, m)[:, None]
    P0 = w * (x == 0) + (1 - w) * (1 - f) ** 2
    P1 = w * (x == 1) + (1 - w) * 2 * f * (1 - f)
    p0 = np.round(255 * P0).astype(np.uint8)
    p1 = np.minimum(np.round(255 * P1), 255 - p0).astype(np.uint8)
    return p0, p1, rng.random((m, N)) < 0.04


@pytest.fixture(scope="module")
def bgen_file(tmp_path_factory):
    """A 177-sample x 130-variant BGEN file over two chromosomes, written
    in three chunks, and the variant IDs in the reference's format."""
    rng = np.random.default_rng(12)
    m, N = 130, 177
    p0, p1, miss = probabilities(rng, m, N)
    pairs = np.array([("A", "C"), ("G", "T"), ("C", "T"), ("A", "G")])
    al = pairs[rng.integers(0, 4, m)]
    chrom = np.where(np.arange(m) < 70, "01", "02")
    pos = np.r_[np.cumsum(rng.integers(1, 900, 70)),
                np.cumsum(rng.integers(1, 900, 60))] + 1000
    variants = {"chromosome": chrom, "position": pos,
                "rsid": np.array([f"rs{j}" for j in range(m)]),
                "varid": np.array([f"v{j}" for j in range(m)]),
                "allele1": al[:, 0], "allele2": al[:, 1]}
    blocks = [chip_smoke.bgen_blocks(
        torch, *(torch.as_tensor(a[s]) for a in (p0, p1, miss))).numpy()
        for s in (slice(0, 50), slice(50, 51), slice(51, m))]
    path = str(tmp_path_factory.mktemp("bgen") / "data.bgen")
    raw, written = chip_smoke.write_bgen(path, variants, N, blocks,
                                         workers=2)
    assert raw == m * (10 + 3 * N) and written == os.path.getsize(path)
    ids = [f"{int(c)}_{p}_{a}_{b}" for c, p, a, b in
           zip(chrom, pos, al[:, 0], al[:, 1])]
    return path, ids, N


def test_read_bgi_equal_jax(bgen_file):
    path, ids, _ = bgen_file
    a = jbgen.snp_readBGI(path + ".bgi")
    b = pt.snp_readBGI(path + ".bgi")
    assert list(a.columns) == list(b)
    for k in b:
        assert a[k].tolist() == b[k].tolist(), k
    pick = [ids[5], ids[100], ids[0], ids[5]]
    a = jbgen.snp_readBGI(path + ".bgi", pick)
    b = pt.snp_readBGI(path + ".bgi", pick)
    for k in b:
        assert a[k].tolist() == b[k].tolist(), k
    for mod in (jbgen, pbgen):
        with pytest.raises(ValueError, match="not been found"):
            mod.snp_readBGI(path + ".bgi", ["3_1_A_C"])
    assert pbgen.format_snp_id(["1_88169_C_T", "01_88169_C_T"]) == \
        jbgen.format_snp_id(["1_88169_C_T", "01_88169_C_T"])
    with pytest.raises(ValueError):
        pbgen.format_snp_id(["1:88169_C_T"])


@pytest.mark.parametrize("chunk", [4096, 7])
def test_read_dosage_bit_equal(bgen_file, chunk):
    path, ids, _ = bgen_file
    sel = ids[::-1][:100] + ids[100:]        # out of file order
    a = jbgen.snp_readBGEN(path, [sel], chunk_variants=chunk)
    b = pt.snp_readBGEN(path, [sel], chunk_variants=chunk)
    assert isinstance(b, pt.DosagePack)
    assert np.array_equal(np.asarray(b.codes), a.codes)
    for k in ("freq", "info"):
        np.testing.assert_allclose(b.map[k], a.map[k].to_numpy(), rtol=0,
                                   atol=1e-12, equal_nan=True)
    for k in ("chromosome", "marker.ID", "rsid", "physical.pos", "allele1",
              "allele2"):
        assert b.map[k].tolist() == a.map[k].tolist(), k


@pytest.mark.parametrize("seed", [0, 7])
def test_random_hard_calls_bit_equal(bgen_file, seed):
    path, ids, _ = bgen_file
    a = jbgen.snp_readBGEN(path, [ids], read_as="random", seed=seed,
                           chunk_variants=40)
    b = pt.snp_readBGEN(path, [ids], read_as="random", seed=seed,
                        chunk_variants=40)
    assert isinstance(b, pt.GenoPack)
    assert np.array_equal(b.packed, a.packed)
    np.testing.assert_allclose(b.map["info"], a.map["info"].to_numpy(),
                               rtol=0, atol=1e-12, equal_nan=True)


def test_ind_row_subsets(bgen_file):
    path, ids, N = bgen_file
    rows = np.r_[np.arange(0, N, 3), [1, 1]]
    a = jbgen.snp_readBGEN(path, [ids], ind_row=rows)
    b = pt.snp_readBGEN(path, [ids], ind_row=rows)
    full = pt.snp_readBGEN(path, [ids])
    assert np.array_equal(b.codes, a.codes)
    assert np.array_equal(b.codes, full.codes[:, rows])
    np.testing.assert_allclose(b.map["info"], a.map["info"].to_numpy(),
                               rtol=0, atol=1e-12, equal_nan=True)
    r = pt.snp_readBGEN(path, [ids], ind_row=rows, read_as="random", seed=3)
    assert np.array_equal(r.packed, jbgen.snp_readBGEN(
        path, [ids], ind_row=rows, read_as="random", seed=3).packed)


def test_two_files_and_bgi_dir(bgen_file, tmp_path):
    path, ids, _ = bgen_file
    other = tmp_path / "copy.bgen"
    shutil.copy(path, other)
    bgi_dir = tmp_path / "idx"
    bgi_dir.mkdir()
    shutil.copy(path + ".bgi", bgi_dir / "data.bgen.bgi")
    shutil.copy(path + ".bgi", bgi_dir / "copy.bgen.bgi")
    lists = [ids[:30], ids[60:90]]
    a = jbgen.snp_readBGEN([path, str(other)], lists, bgi_dir=bgi_dir)
    b = pt.snp_readBGEN([path, str(other)], lists, bgi_dir=bgi_dir)
    assert np.array_equal(b.codes, a.codes) and b.m == 60


def test_plain_decode_is_the_native_decode(bgen_file):
    """read_variant_plain / decode_e_plain (the JAX package's Python decode)
    against the native pool on every variant."""
    import mmap as mmap_mod

    path, ids, N = bgen_file
    info = pt.snp_readBGI(path + ".bgi")
    rows = np.arange(N)[::-1]
    with open(path, "rb") as f:
        buf = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
    try:
        _, goffs, sizes = pbgen._headers(buf, info["file_start_position"], N)
        chunk = bytes(buf[:])
        codes, inf, frq = pbgen.decode_variants(chunk, goffs, sizes, N, rows)
        e = pbgen.decode_e(chunk, goffs, sizes, N, rows)
        for j in range(len(goffs)):
            c, i_, f_ = pbgen.read_variant_plain(
                buf, int(goffs[j]), int(sizes[j]), rows, True, N, None)
            assert np.array_equal(c, codes[j])
            assert np.array_equal(pbgen.decode_e_plain(
                buf, int(goffs[j]), int(sizes[j]), rows, N), e[j])
            np.testing.assert_allclose([inf[j], frq[j]], [i_, f_], rtol=0,
                                       atol=1e-12, equal_nan=True)
    finally:
        buf.close()


def test_native_decode_raises_when_it_cannot_build(bgen_file, tmp_path,
                                                   monkeypatch):
    """No Python fallback: a source that does not compile raises."""
    path, ids, _ = bgen_file
    broken = tmp_path / "io_native.cpp"
    broken.write_text(pbgen.IO_SOURCE.read_text() + "\nnot C++ at all\n")
    monkeypatch.setattr(pbgen, "IO_SOURCE", broken)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pt.snp_readBGEN(path, [ids[:3]])
    # hard calls are sampled on the host and need no native library
    assert pt.snp_readBGEN(path, [ids[:3]], read_as="random").m == 3


def test_backingfile_store(bgen_file, tmp_path):
    """The streamed ingest into a .dpk memmap; the store reads back in
    both packages."""
    path, ids, _ = bgen_file
    store = tmp_path / "ex.dpk"
    b = pt.snp_readBGEN(path, [ids], backingfile=store, chunk_variants=9)
    assert isinstance(b.codes, np.memmap)
    a = jbgen.snp_readBGEN(path, [ids])
    assert np.array_equal(np.asarray(b.codes), a.codes)
    for load in (pt.DosagePack.load, JaxDosagePack.load):
        back = load(store)
        assert np.array_equal(np.asarray(back.codes), a.codes)
        np.testing.assert_allclose(np.asarray(back.map["freq"]),
                                   a.map["freq"].to_numpy(), equal_nan=True)
    g = tmp_path / "hard"
    r = pt.snp_readBGEN(path, [ids], read_as="random", seed=1,
                        backingfile=g)
    assert np.array_equal(np.asarray(pt.snp_attach(str(g) + ".gpk").packed),
                          r.packed)


def test_halfwritten_store_is_removed(bgen_file, tmp_path, monkeypatch):
    path, ids, _ = bgen_file
    store = tmp_path / "boom.dpk"
    calls = {"k": 0}

    def exploding(*a, **kw):
        calls["k"] += 1
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(pbgen, "_ingest_one_bgen", exploding)
    with pytest.raises(RuntimeError, match="disk on fire"):
        pt.snp_readBGEN(path, [ids], backingfile=store)
    assert calls["k"] == 1 and not store.exists()


@pytest.mark.parametrize("K", [1, 3])
def test_prod_bgen(bgen_file, K):
    path, ids, N = bgen_file
    rng = np.random.default_rng(K)
    beta = rng.standard_normal((len(ids), K)).squeeze()
    rows = np.arange(0, N, 2)
    ref = jbgen.snp_prodBGEN(path, beta, ids, ind_row=rows, engine="host")
    host = pt.snp_prodBGEN(path, beta, ids, ind_row=rows, engine="host",
                           block_size=16)
    assert host.shape == ref.shape
    assert np.array_equal(np.isnan(host), np.isnan(ref))
    assert np.isnan(ref).any() and not np.isnan(ref).all()
    scale = np.nanmax(np.abs(ref))
    assert np.nanmax(np.abs(host - ref)) <= 1e-12 * scale
    for engine in ("device", "auto"):
        dev = pt.snp_prodBGEN(path, beta, ids, ind_row=rows, engine=engine,
                              block_size=7)
        np.testing.assert_allclose(dev, ref, rtol=5e-6, atol=5e-6,
                                   equal_nan=True)
    if not torch.cuda.is_available():
        # the device rule: "auto" and "device" need the port's device
        with pt.config.options(device="cuda"):
            for engine in ("device", "auto"):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    pt.snp_prodBGEN(path, beta, ids, engine=engine)
            host = pt.snp_prodBGEN(path, beta, ids, engine="host")
            assert host.shape[0] == N


@pytest.mark.parametrize("engine", ["host", "device"])
def test_prod_bgen_unsorted_list(bgen_file, engine, monkeypatch):
    """A list out of file order (sumstats order, repeats) against the JAX
    host engine, at the tolerances of test_prod_bgen; every block is decoded
    from the memory-mapped file in place, never from a copied byte span."""
    import mmap as mmap_mod

    path, ids, N = bgen_file
    rng = np.random.default_rng(5)
    pick = [ids[i] for i in np.r_[rng.permutation(len(ids)), [3, 3]]]
    beta = rng.standard_normal((len(pick), 2))
    ref = jbgen.snp_prodBGEN(path, beta, pick, engine="host")
    seen = []
    decode = pbgen.decode_e

    def spy(buf, *args):
        seen.append(type(buf))
        return decode(buf, *args)

    monkeypatch.setattr(pbgen, "decode_e", spy)
    got = pt.snp_prodBGEN(path, beta, pick, engine=engine, block_size=16)
    assert seen and set(seen) == {mmap_mod.mmap}
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    if engine == "host":
        assert np.nanmax(np.abs(got - ref)) <= 1e-12 * np.nanmax(np.abs(ref))
    else:
        np.testing.assert_allclose(got, ref, rtol=5e-6, atol=5e-6,
                                   equal_nan=True)


def test_bad_files(bgen_file, tmp_path):
    path, _, _ = bgen_file
    bad = tmp_path / "bad.bgen"
    data = bytearray(open(path, "rb").read(64))
    data[16:20] = b"nope"
    bad.write_bytes(bytes(data))
    for mod in (jbgen, pbgen):
        with pytest.raises(ValueError, match="not a BGEN file"):
            mod.check_bgen_format(bad)
    with pytest.raises(ValueError, match="read_as"):
        pt.snp_readBGEN(path, [[]], read_as="maybe")
