"""One run of one cell: set-up, the measured window, the reference check
and the result line.

The window runs whole jobs back to back and starts none once `--seconds`
have passed; it ends when the last job ends, with a synchronize. With
`--trace 1` the window is instead `trace_jobs` whole jobs (the cell's
file) under torch.profiler, and the per-layer metrics are read from it.
After the window the program's state is dropped and the job's plain
reference judges a sample of the window's jobs drawn from the seed.

A job kind (`jobs/<job>.py`) provides:
  setup(ctx) -> state        inputs from the seed, the program's set-up
                             and the warm-up of the cell's own shapes
  run(state, ctx, i, seed)   one whole job, synchronized; its result
  counters(state)            the program's launch counters (cumulative)
  shapes(state)              what the per-layer readers need
  release(state)             drop the program's state before the check,
                             keeping the benchmark's own inputs
  check(state, ctx, sample)  {number: value} over the jobs in `sample`,
                             [(index, seed, result)]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

from benchlib import spec as specs

FORBIDDEN = ("jax", "jaxlib", "flax", "bigsnpr_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names in sys.modules that the run may not load, compared
    whole ("bigsnpr_tpu_torch" is not "bigsnpr_tpu")."""
    mods = sys.modules if modules is None else modules
    return sorted({k.split(".")[0] for k in list(mods)} & set(FORBIDDEN))


def job_seed(seed: int, i: int) -> int:
    """The seed handed to job i of a run (i = -1: the warm-up)."""
    st = np.random.SeedSequence([int(seed), 7, i + 1]).generate_state(1)
    return int(st[0] % (2**31 - 2)) + 1


def set_caches(root) -> str:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port's nvcc / g++ libraries, and torch's extension and Triton
    caches should anything use them."""
    cache = os.path.join(str(root), ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    build = os.path.join(cache, "build")
    os.environ["BIGSNPR_COMPILE_CACHE"] = build
    return build


def card_info() -> dict:
    """The card's name, power limit and SM clocks from nvidia-smi, or {}
    where it cannot be read."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return {}
    if r.returncode != 0 or not r.stdout.strip():
        return {}
    vals = [v.strip() for v in r.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(("name", "power_limit", "sm_clock", "sm_clock_max"),
                    vals))


class Ctx:
    """What a job sees: its configuration, traffic mix and cell file, the
    run's seed and device, a log to standard error, and host-clock spans
    that the per-layer readers take differences of."""

    def __init__(self, cell, cfg, traffic, cellf, seed, dev):
        self.cell, self.cfg, self.traffic, self.cellf = cell, cfg, traffic, \
            cellf
        self.seed, self.dev = int(seed), dev
        self.spans: dict = {}

    def log(self, *a):
        print(*a, file=sys.stderr, flush=True)

    def span(self, name, seconds):
        self.spans[name] = self.spans.get(name, 0.0) + seconds

    def sync(self):
        if self.dev.type == "cuda":
            import torch

            torch.cuda.synchronize(self.dev)


def _reservoir(rng, kept, k, i, item):
    """Algorithm R: a uniform sample of k of the items seen so far."""
    if len(kept) < k:
        kept.append(item)
    else:
        r = int(rng.integers(0, i + 1))
        if r < k:
            kept[r] = item


def run_cell(name, seed, seconds, trace, dev, t_start, cfg_override=None,
             traffic_override=None, root=specs.ROOT):
    """Runs the cell; returns the result line (a dict) and the checks
    [(number, value, limit)] in their order. The overrides (tests at a
    small size) replace keys of the configuration and the traffic mix."""
    import torch

    bench = os.path.join(str(root), "benchmark")
    spec = specs.benchmark(root)
    cw = specs.cell(spec, name)
    cfg = dict(specs.config(spec, cw["config"], root))
    if cfg_override:
        cfg.update(cfg_override)
    traffic = dict(specs.traffic(cw["traffic"], bench))
    traffic.update(traffic_override or {})
    cellf = specs.cell_file(name, bench)
    job = specs.load_module("jobs", traffic["job"], bench)
    ctx = Ctx(name, cfg, traffic, cellf, seed, dev)
    card = card_info() if dev.type == "cuda" else {}
    if card:
        ctx.log(f"card: {card}")

    state = job.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    ctx.log(f"setup_s {setup_s:.3f}")
    cuda = dev.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    c0, s0 = dict(job.counters(state)), dict(ctx.spans)
    rng = np.random.default_rng([int(seed), 5])
    keep = int(cellf.get("checked_jobs", 1))
    sample, jobs, tr = [], 0, None
    from torch.profiler import record_function

    job_times = []

    def one():
        nonlocal jobs
        js = job_seed(seed, jobs)
        t = time.perf_counter()
        with record_function("bench.job"):
            res = job.run(state, ctx, jobs, js)
        job_times.append(time.perf_counter() - t)
        _reservoir(rng, sample, keep, jobs, (jobs, js, res))
        jobs += 1

    if trace:
        from benchlib.trace import DeviceTrace

        with DeviceTrace(torch, dev) as tr:
            for _ in range(max(1, int(cellf.get("trace_jobs", 1)))):
                one()
        window_s = tr.span_s
    else:
        t0 = time.perf_counter()
        while True:
            one()
            if time.perf_counter() - t0 >= seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx.log(f"window {window_s:.3f} s, {jobs} jobs: "
            f"{' '.join(f'{t:.3f}' for t in job_times)}")
    c1 = job.counters(state)
    refuse_forbidden()
    rec = {"cell": name, "jobs": jobs, "window_s": window_s,
           "setup_s": setup_s, "peak_window_bytes": peak_window,
           "counters": {k: c1[k] - c0.get(k, 0) for k in c1},
           "spans": {k: v - s0.get(k, 0.0) for k, v in ctx.spans.items()},
           "trace": tr, "shapes": job.shapes(state), "log": ctx.log}
    metrics = {}
    for m in specs.metrics_for(spec, name, bool(trace)):
        v = specs.load_module("metrics", m["name"], bench).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": int(cw["chips"]),
              "memory_peak_bytes": int(max(peak_setup, peak_window))}
    line = {"correct": False, "attempted": jobs, "failed": 0,
            "metrics": metrics, "device": device}
    if trace:
        s = tr.summary
        device["busy_s"] = s["busy_s"]
        device["window_s"] = window_s
        ops = sorted(s["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k[:160], v] for k, v in ops],
                             "idle_gaps": s["idle"]}
    if card:
        line["card"] = card

    job.release(state)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    vals = job.check(state, ctx, sorted(sample, key=lambda t: t[0]))
    ctx.log(f"check {time.perf_counter() - t_check:.3f} s")
    # again once the references have run: none of them may load JAX either
    refuse_forbidden()
    limits = cellf["limits"]
    checks = [(k, float(v), float(limits[k])) for k, v in vals.items()]
    failed = [k for k, v, lim in checks if not v <= lim]
    line["correct"] = not failed and len(checks) == len(limits)
    line["failed"] = len(sample) if failed else 0
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line, checks


class ForbiddenModules(RuntimeError):
    pass


def refuse_forbidden():
    """Raises ForbiddenModules where sys.modules holds JAX or the JAX
    package: the run then prints no result line."""
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)


def main(argv, t_start) -> int:
    ap = argparse.ArgumentParser(
        description="Run one cell of the benchmark and print its result "
        "line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = set_caches(specs.ROOT)
    import torch

    spec = specs.benchmark()
    chips = int(specs.cell(spec, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(specs.ROOT))
    from bigsnpr_tpu_torch import config

    config.enable_compilation_cache(build)
    try:
        line, checks = run_cell(args.workload, args.seed, args.seconds,
                                args.trace, torch.device("cuda", 0), t_start)
    except ForbiddenModules as e:
        print(f"modules of JAX or the JAX package were loaded: {e}",
              file=sys.stderr)
        return 3
    except Exception:       # noqa: BLE001 - reported, and no result line
        traceback.print_exc()
        return 1
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
