"""Port parity: counts, column stats, MAF and scaling
(bigsnpr_tpu_torch.ops.stats against bigsnpr_tpu.ops.stats).

Counts are integers and must be bit-equal; everything after them is
float64 host arithmetic on the same counts, held within 1e-12."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu as bt
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch import interop

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def to_port(jpack):
    return interop.pack_from_numpy(np.asarray(jpack.packed), jpack.n)


def with_pad_bits(packed, n, rng):
    """The bytes with random values in the last byte's pad bits (the
    samples >= n), which count as nothing."""
    packed = packed.copy()
    if n % 4:
        pad = rng.integers(0, 256, len(packed), dtype=np.uint8)
        packed[:, -1] |= pad & np.uint8((0xFF << (2 * (n % 4))) & 0xFF)
    return packed


@pytest.mark.parametrize("n,m,na", [(101, 70, 0.0), (102, 70, 0.1),
                                    (103, 133, 0.3), (64, 9, 0.02),
                                    (1, 5, 0.3), (250, 17, 0.5)])
def test_counts_and_colstats_bit_equal(n, m, na):
    jp = bt.snp_fake(n, m, seed=n, na_prob=na)
    pp = to_port(jp)
    np.testing.assert_array_equal(pt.snp_counts(pp), bt.snp_counts(jp))
    rng = np.random.default_rng(1)
    ind_row = rng.choice(n, size=max(n // 2, 1), replace=False)
    np.testing.assert_array_equal(pt.snp_counts(pp, ind_row=ind_row),
                                  bt.snp_counts(jp, ind_row=ind_row))
    # repeated, unsorted indices count as often as they appear
    rep = rng.integers(0, n, 2 * n + 3)
    np.testing.assert_array_equal(pt.snp_counts(pp, ind_row=rep),
                                  bt.snp_counts(jp, ind_row=rep))
    # a small block forces several device blocks
    np.testing.assert_array_equal(pt.snp_counts(pp, block=16),
                                  bt.snp_counts(jp))
    # set pad bits are dropped, as in the JAX package
    padded = with_pad_bits(np.asarray(jp.packed), n, rng)
    jq, pq = bt.GenoPack(packed=padded, n=n), interop.pack_from_numpy(padded,
                                                                      n)
    for ir in (None, rep):
        np.testing.assert_array_equal(pt.snp_counts(pq, ind_row=ir),
                                      bt.snp_counts(jq, ind_row=ir))
        np.testing.assert_array_equal(pt.snp_counts(pq, ind_row=ir),
                                      pt.snp_counts(pp, ind_row=ir))
    for ir in (None, ind_row):
        ps, js = pt.snp_colstats(pp, ind_row=ir), bt.snp_colstats(jp, ind_row=ir)
        for key in ("sumX", "denoX", "nona"):
            np.testing.assert_array_equal(ps[key], js[key])


def test_counts_twin_against_the_codes():
    """`counts_plain` against counts taken from `np_unpack_codes`, with
    pad bits set and repeated row indices; a negative index counts from
    the end; the kernel's wrapper refuses a CPU pack."""
    from bigsnpr_tpu_torch.core.unpack import np_unpack_codes
    from bigsnpr_tpu_torch.ops import geno_kernels as gk
    from bigsnpr_tpu_torch.ops.stats import counts_plain

    rng = np.random.default_rng(5)
    n, m = 1003, 41
    packed = rng.integers(0, 256, (m, (n + 3) // 4), dtype=np.uint8)
    codes = np_unpack_codes(packed, n)
    rows = rng.integers(0, n, 3 * n)
    for ir in (None, rows):
        c = codes if ir is None else codes[:, ir]
        ref = np.stack([(c == k).sum(1) for k in (3, 2, 0, 1)])
        got = counts_plain(torch.as_tensor(packed), n,
                           None if ir is None else torch.as_tensor(ir),
                           block=8)
        np.testing.assert_array_equal(got.numpy(), ref)
    pp = pt.GenoPack(packed=packed, n=n)
    np.testing.assert_array_equal(pt.snp_counts(pp, ind_row=[-1, 0, -n]),
                                  pt.snp_counts(pp, ind_row=[n - 1, 0, 0]))
    with pytest.raises(ValueError, match="CUDA pack"):
        gk.counts(torch.as_tensor(packed), n)


def test_maf_and_scaling_match_jax():
    jp = bt.snp_fake(157, 88, seed=3, na_prob=0.07)
    pp = to_port(jp)
    ir = np.arange(0, 157, 3)
    np.testing.assert_allclose(pt.snp_MAF(pp), bt.snp_MAF(jp), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(pt.snp_MAF(pp, ind_row=ir),
                               bt.snp_MAF(jp, ind_row=ir), rtol=1e-12, atol=1e-12)
    pm, jm = pt.bed_MAF(pp), bt.bed_MAF(jp)
    for key in ("ac", "mac", "N"):
        np.testing.assert_array_equal(pm[key], jm[key].to_numpy())
    for key in ("af", "maf"):
        np.testing.assert_allclose(pm[key], jm[key].to_numpy(), rtol=1e-12,
                                   atol=1e-12)
    for ps, js in ((pt.bed_scaleBinom(pp), bt.bed_scaleBinom(jp)),
                   (pt.bed_scaleBinom(pp, ind_row=ir),
                    bt.bed_scaleBinom(jp, ind_row=ir)),
                   (pt.snp_scaleBinom(1)(pp), bt.snp_scaleBinom(1)(jp))):
        for key in ("center", "scale"):
            np.testing.assert_allclose(ps[key], js[key], rtol=1e-12, atol=1e-12)


def test_monomorphic_and_all_na_variants():
    X = np.full((40, 3), 2.0)
    X[:, 1] = np.nan
    X[::2, 2] = 1.0
    from bigsnpr_tpu_torch.core import unpack

    pp = pt.GenoPack(packed=unpack.np_pack_codes(unpack.np_dosage_to_codes(X.T)),
                     n=40)
    sc = pt.bed_scaleBinom(pp)
    assert sc["scale"][0] == 0.0 and sc["scale"][1] == 0.0
    assert pt.snp_MAF(pp)[1] == 0.0
    np.testing.assert_array_equal(pt.snp_counts(pp)[:, 1], [0, 0, 0, 40])


def test_as_scaling_fun():
    pp = pt.snp_fake(20, 6, seed=1)
    f = pt.as_scaling_fun(np.arange(6.0), np.ones(6))
    np.testing.assert_array_equal(f(pp)["center"], np.arange(6.0))
    with pytest.raises(ValueError):
        pt.as_scaling_fun(np.ones(5), np.ones(5))(pp)
