"""The controls' readings, beside the program's, for setting the limits
that decide `correct` (not run by the benchmark's own runs):

    python3 benchmark/control.py --workload ldpred2_hm3.grid --seeds 3 4 5

For each seed: the cell's set-up, `--jobs` jobs of the program, then the
cell's numbers for the program's jobs (as a run reads them) and for the
control, the plain reference put in the program's place one precision
below the configuration's (the job kind's `control`), for the seeds of
`--control-seeds` (default: every seed). Prints a JSON line a seed.
"""

import time

T_START = time.perf_counter()

import argparse                                     # noqa: E402
import json                                         # noqa: E402
import sys                                          # noqa: E402
from pathlib import Path                            # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib import harness, spec as specs          # noqa: E402


def readings(name, seed, jobs, dev, with_control=True):
    import torch

    spec = specs.benchmark()
    cw = specs.cell(spec, name)
    cfg = specs.config(spec, cw["config"])
    traffic = specs.traffic(cw["traffic"])
    cellf = specs.cell_file(name)
    job = specs.load_module("jobs", traffic["job"])
    ctx = harness.Ctx(name, cfg, traffic, cellf, seed, dev)
    st = job.setup(ctx)
    sample = []
    for i in range(jobs):
        js = harness.job_seed(seed, i)
        sample.append((i, js, job.run(st, ctx, i, js)))
    job.release(st)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    program = job.check(st, ctx, sample)
    t1 = time.perf_counter()
    control = job.control(st, ctx, sample) if with_control else None
    return {"workload": name, "seed": seed, "program": program,
            "control": control, "check_s": t1 - t0,
            "control_s": time.perf_counter() - t1}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    build = harness.set_caches(specs.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(specs.ROOT))
    from bigsnpr_tpu_torch import config

    config.enable_compilation_cache(build)
    for seed in args.seeds:
        ctl = args.control_seeds is None or seed in args.control_seeds
        print(json.dumps(readings(args.workload, seed, args.jobs,
                                  torch.device("cuda", 0), ctl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
