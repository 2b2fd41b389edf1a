"""The CUDA kernels K1/K2 against their plain-torch twins on a card.

Imports only torch and the port, so it runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Without a CUDA device every test here skips. Tolerance: max |kernel -
twin| <= 1e-4 * max |twin| (float32 sums in two orders)."""

import numpy as np
import pytest
import torch

import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.ops import geno_kernels as gk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,l", [(1001, 777, 1), (1002, 1500, 12),
                                   (1003, 3001, 20), (4097, 513, 50)])
def test_kernels_match_twins(cuda, n, m, l):
    pp = pt.snp_fake(n, m, seed=l, na_prob=0.05)
    packed = pp.device_packed(cuda)
    rng = np.random.default_rng(l)
    c = torch.as_tensor(rng.uniform(0, 2, m), dtype=torch.float32, device=cuda)
    inv = torch.as_tensor(rng.uniform(0, 3, m), dtype=torch.float32,
                          device=cuda)
    inv[::11] = 0
    V = torch.randn(n, l, device=cuda)
    U = torch.randn(m, l, device=cuda)
    before = dict(gk.launches)
    for kern, plain, W in ((gk.cprod, gk.cprod_plain, V),
                           (gk.prod, gk.prod_plain, U)):
        out, ref = kern(packed, n, W, c, inv), plain(packed, n, W, c, inv)
        torch.cuda.synchronize()
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert gk.launches["cprod"] == before["cprod"] + 1
    assert gk.launches["prod"] == before["prod"] + 1


@pytest.mark.cuda
def test_operator_on_card_matches_cpu(cuda):
    pp = pt.snp_fake(533, 700, seed=3, na_prob=0.05)
    sc = pt.bed_scaleBinom(pp, device="cpu")
    rows = np.arange(0, 533, 2)
    cols = np.arange(0, 700, 3)
    ops = [pt.GenoOperator(pp, sc["center"], sc["scale"], ind_row=rows,
                           ind_col=cols, device=d) for d in ("cpu", cuda)]
    V = np.random.default_rng(0).standard_normal((len(rows), 20))
    (B0, Y0), (B1, Y1) = (op.power(V) for op in ops)
    assert np.abs(B1 - B0).max() <= 1e-4 * np.abs(B0).max()
    assert np.abs(Y1 - Y0).max() <= 1e-4 * np.abs(Y0).max()


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(cuda):
    """No float atomics: the split reduction runs in a fixed order."""
    pp = pt.snp_fake(5000, 3000, seed=1, na_prob=0.01)
    packed = pp.device_packed(cuda)
    c = torch.ones(3000, device=cuda)
    inv = torch.ones(3000, device=cuda)
    V = torch.randn(5000, 20, device=cuda)
    U = torch.randn(3000, 20, device=cuda)
    assert torch.equal(gk.cprod(packed, 5000, V, c, inv),
                       gk.cprod(packed, 5000, V, c, inv))
    assert torch.equal(gk.prod(packed, 5000, U, c, inv),
                       gk.prod(packed, 5000, U, c, inv))
