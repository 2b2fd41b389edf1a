"""Each cell's control, the plain reference put in the program's place
one precision below the configuration's (PCA: TF32 operands for
float32; LDpred2: bfloat16 for float32), fails at least one of the
cell's numbers; at the small sizes, on the CPU. The same readings at the
cells' own sizes on the card come from `benchmark/control.py`."""

import pytest
import torch

from benchlib import harness
from benchlib import spec as specs

from conftest import SMALL


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails(cell):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    spec = specs.benchmark()
    cw = specs.cell(spec, cell)
    cfg = dict(specs.config(spec, cw["config"]))
    tr = dict(specs.traffic(cw["traffic"]))
    cfg.update(SMALL[cell][0])
    tr.update(SMALL[cell][1])
    cellf = specs.cell_file(cell)
    job = specs.load_module("jobs", tr["job"])
    ctx = harness.Ctx(cell, cfg, tr, cellf, 424242, torch.device("cpu"))
    st = job.setup(ctx)
    js = harness.job_seed(424242, 0)
    sample = [(0, js, job.run(st, ctx, 0, js))]
    job.release(st)
    limits = cellf["limits"]
    prog = job.check(st, ctx, sample)
    ctl = job.control(st, ctx, sample)
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctl[k] > limits[k] for k in limits), ctl
