"""The port's `warmup` against the JAX package's at tiny shapes on the CPU:
the same sections come back (the JAX package's "svd" and "gibbs", and the
port's "build", the sources built and loaded), each with its seconds; the
two part functions return seconds; with no CUDA and no request for the
CPU it raises, like every entry point."""

import pytest
import torch

import bigsnpr_tpu as bt
import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.ops import cuda_build
from bigsnpr_tpu_torch.io import bgen as pbgen

torch.set_num_threads(2)

SHAPES = dict(m=64, n=32, k=2, gibbs_m=256, gibbs_block=64, gibbs_W=8,
              chains=2, grid_cells=2, verbose=False)


def test_warmup_sections_match_jax():
    ref = bt.warmup(**SHAPES)
    out = pt.warmup(device="cpu", **SHAPES)
    assert set(out) - {"build"} == set(ref) == {"svd", "gibbs"}
    assert "build" in out
    assert all(isinstance(v, float) and v >= 0 for v in out.values())
    assert str(pbgen.IO_SOURCE) in cuda_build._libs
    assert pt.warmup(device="cpu", verbose=False).keys() == {"build"}
    assert bt.warmup(verbose=False).keys() == set()


@pytest.mark.parametrize("mxu", ["highest", "int8"])
def test_warmup_parts_return_seconds(mxu):
    with pt.config.options(pallas_mxu=mxu):
        t = pt.warmup_svd(40, 24, k=3, nona=(mxu == "int8"), device="cpu")
    assert isinstance(t, float) and t >= 0
    t = pt.warmup_gibbs(300, block=100, W=5, chains=3, grid_cells=2,
                        device="cpu", use_mle=False)
    assert isinstance(t, float) and t >= 0


def test_warmup_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pt.config.options(device="cuda"):
        for fn in (lambda: pt.warmup(m=64, n=32, verbose=False),
                   lambda: pt.warmup_svd(64, 32),
                   lambda: pt.warmup_gibbs(256, block=64, W=8)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
