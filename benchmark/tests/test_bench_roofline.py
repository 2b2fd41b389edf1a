"""The yardstick's arithmetic on known shapes."""

import pytest

from benchlib import roofline


def test_geno_product_is_bytes_bound_at_the_pca_shape():
    n, m, l = 488_377, 200_000, 30
    least, by = roofline.geno_product(n, m, l)
    nbytes = m * ((n + 3) // 4) + 4 * (n + m) * l
    assert by == "bytes"
    assert least == pytest.approx(nbytes / 3.35e12)
    assert least * 1e3 == pytest.approx(7.3, abs=0.05)


def test_geno_product_counts_the_algorithm_not_the_bit_planes():
    # 2 n m l: the three-term bit-plane scheme's 6x work is not counted
    n, m, l = 50_000, 100_000, 20
    ops = 2.0 * n * m * l
    assert ops == pytest.approx(0.2e12)
    least, by = roofline.geno_product(n, m, l)
    assert least >= ops / roofline.PEAK_DENSE_OPS
    # deep enough columns turn the bound to operations
    least, by = roofline.geno_product(100_000, 100_000, 4096)
    assert by == "operations"
    assert least == pytest.approx(2.0 * 100_000 * 100_000 * 4096 / 1.979e15)


@pytest.mark.parametrize("scheme", ["highest", "split2", "int8", "int8m"])
def test_geno_count_is_the_same_whatever_the_scheme(scheme, monkeypatch):
    from bigsnpr_tpu_torch import config

    monkeypatch.setattr(config, "pallas_mxu", scheme)
    metric = pytest.importorskip("benchlib.spec").load_module(
        "metrics", "geno_gemm_roofline_pct")

    class Trace:
        def kernel_s(self, _):
            return 1.0

        def kernel_n(self, _):
            return 10

    rec = {"trace": Trace(), "shapes": {"geno": {"n": 488_377,
                                                  "m": 200_000, "l": 30}},
           "counters": {"cprod": 5, "prod": 5}, "log": lambda *a: None}
    least, _ = roofline.geno_product(488_377, 200_000, 30)
    assert metric.read(rec) == pytest.approx(100 * 10 * least)


def test_gibbs_sweep_bound():
    # 100,000 variants, ~4.6e7 in-block LD entries, 30 chains
    least, by = roofline.gibbs_sweep(46_000_000, 100_000, 30, 3, 5, 1)
    nbytes = 4 * 46_000_000 + 4 * 3 * 100_000 + 30 * 100_000 * 21
    assert by == "bytes"
    assert least == pytest.approx(nbytes / 3.35e12)
    # operations: 20 flops a chain and variant at 67 TFLOP/s
    least, by = roofline.gibbs_sweep(0, 10, 10**9, 0, 0, 0)
    assert by == "operations"
    assert least == pytest.approx(10 * 10**9 * 20 / 67e12)
