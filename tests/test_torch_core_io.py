"""Port parity: 2-bit codes, GenoPack, .bed I/O and subsets
(bigsnpr_tpu_torch.core / .io against bigsnpr_tpu.core / .io).

Everything here is integer or byte data, so every comparison is exact."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
from bigsnpr_tpu.core import unpack as junpack
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop
from bigsnpr_tpu_torch.core import unpack as punpack

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def to_port(jpack):
    return interop.pack_from_numpy(np.asarray(jpack.packed), jpack.n,
                                   fam=jpack.fam, map=jpack.map)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 97])
def test_code_pack_roundtrip(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, size=(13, n), dtype=np.uint8)
    packed = punpack.np_pack_codes(codes)
    np.testing.assert_array_equal(packed, junpack.np_pack_codes(codes))
    np.testing.assert_array_equal(punpack.np_unpack_codes(packed, n), codes)
    got = punpack.unpack_codes(torch.as_tensor(packed), n).numpy()
    np.testing.assert_array_equal(got, codes)
    dosage = rng.choice([0.0, 1.0, 2.0, np.nan], size=(5, n))
    np.testing.assert_array_equal(punpack.np_dosage_to_codes(dosage),
                                  junpack.np_dosage_to_codes(dosage))


def test_unpack_standardized_matches_jax():
    rng = np.random.default_rng(0)
    n, m = 37, 11
    packed = rng.integers(0, 256, size=(m, (n + 3) // 4), dtype=np.uint8)
    center = rng.uniform(0.2, 1.8, m)
    scale = rng.uniform(0.3, 1.0, m)
    ref = np.asarray(junpack.unpack_standardized(packed, n, center, scale))
    got = punpack.unpack_standardized(torch.as_tensor(packed), n,
                                      torch.as_tensor(center),
                                      torch.as_tensor(scale)).numpy()
    # float32 both; the same operations in the same order
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    d, na = punpack.unpack_dosage(torch.as_tensor(packed), n)
    jd, jna = junpack.unpack_dosage(packed, n)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(na.numpy(), np.asarray(jna))


def test_snp_fake_same_bytes_as_jax():
    jp = bt.snp_fake(61, 40, seed=5, na_prob=0.1)
    pp = pt.snp_fake(61, 40, seed=5, na_prob=0.1)
    np.testing.assert_array_equal(pp.packed, jp.packed)
    assert pp.shape == jp.shape == (61, 40)
    for col in pt.core.genotypes.FAM_COLS:
        np.testing.assert_array_equal(pp.fam[col], jp.fam[col].to_numpy())
    for col in pt.core.genotypes.MAP_COLS:
        np.testing.assert_array_equal(pp.map[col], jp.map[col].to_numpy())
    np.testing.assert_array_equal(pp.to_dosage(), jp.to_dosage())


@pytest.mark.parametrize("n", [41, 42, 43, 44])
def test_bed_written_by_port_is_byte_identical(tmp_path, n):
    jp = bt.snp_fake(n, 30, seed=n, na_prob=0.05)
    jfile = bt.snp_writeBed(jp, tmp_path / "jax.bed")
    pfile = pt.snp_writeBed(to_port(jp), tmp_path / "port.bed")
    assert (tmp_path / "jax.bed").read_bytes() == (tmp_path / "port.bed").read_bytes()

    # each package reads the other's files back to the same values
    for a, b in ((jfile, pfile), (pfile, jfile)):
        pr = pt.snp_readBed(a)
        jr = bt.snp_readBed(b)
        np.testing.assert_array_equal(np.asarray(pr.packed), np.asarray(jr.packed))
        assert pr.n == jr.n == n
        for col in pt.core.genotypes.FAM_COLS:
            np.testing.assert_array_equal(pr.fam[col], jr.fam[col].to_numpy())
        for col in pt.core.genotypes.MAP_COLS:
            np.testing.assert_array_equal(pr.map[col], jr.map[col].to_numpy())


def test_read_bed_rejects_bad_files(tmp_path):
    jp = bt.snp_fake(10, 5, seed=1)
    bed = pt.snp_writeBed(to_port(jp), tmp_path / "x.bed")
    raw = (tmp_path / "x.bed").read_bytes()
    (tmp_path / "x.bed").write_bytes(b"\x00" + raw[1:])
    with pytest.raises(ValueError, match="magic"):
        pt.read_bed(bed)
    (tmp_path / "x.bed").write_bytes(raw[:-1])
    with pytest.raises(ValueError, match="expected"):
        pt.read_bed(bed)


@pytest.mark.parametrize("n_sub", [29, 30, 31, 32])
def test_subset_bytes_equal_jax(n_sub):
    jp = bt.snp_fake(57, 33, seed=2, na_prob=0.08)
    pp = to_port(jp)
    rng = np.random.default_rng(n_sub)
    ind_row = rng.choice(57, size=n_sub, replace=False)
    ind_col = np.sort(rng.choice(33, size=20, replace=False))
    js = jp.subset(ind_row=ind_row, ind_col=ind_col)
    ps = pp.subset(ind_row=ind_row, ind_col=ind_col)
    assert ps.n == js.n == n_sub
    np.testing.assert_array_equal(ps.packed, js.packed)
    # the repacked tensor is kept as the subset's device copy
    np.testing.assert_array_equal(ps.device_packed("cpu").numpy(), js.packed)
    np.testing.assert_array_equal(ps.fam["sample.ID"],
                                  js.fam["sample.ID"].to_numpy())
    # column-only and row-only subsets
    np.testing.assert_array_equal(pp.subset(ind_col=ind_col).packed,
                                  jp.subset(ind_col=ind_col).packed)
    np.testing.assert_array_equal(pp.subset(ind_row=ind_row).packed,
                                  jp.subset(ind_row=ind_row).packed)


def test_readBed2_subset_matches_jax(tmp_path):
    jp = bt.snp_fake(45, 26, seed=8, na_prob=0.05)
    f = bt.snp_writeBed(jp, tmp_path / "a.bed")
    ind_row = np.array([3, 0, 44, 17, 9])
    ind_col = np.array([1, 5, 25])
    np.testing.assert_array_equal(
        pt.snp_readBed2(f, ind_row=ind_row, ind_col=ind_col).packed,
        bt.snp_readBed2(f, ind_row=ind_row, ind_col=ind_col).packed)


def test_device_packed_is_cached_and_exact():
    pp = pt.snp_fake(23, 9, seed=4)
    a = pp.device_packed("cpu")
    assert a is pp.device_packed("cpu")
    assert a.dtype == torch.uint8 and tuple(a.shape) == pp.packed.shape
    np.testing.assert_array_equal(a.numpy(), pp.packed)
