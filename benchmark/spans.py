"""Where the device waits, by the program's own spans, in one cell on the
card:

    python3 benchmark/spans.py --workload ldpred2_hm3.grid --seed 7

Runs the cell's set-up as `run.py` does, then the cell file's
`trace_jobs` whole jobs under torch.profiler (CUDA
activity, as the benchmark's traced runs) with the program's recorder
on (`bigsnpr_tpu_torch.utils.profiling.recording`), and prints one JSON
line:

- `idle_by_span`: the device's idle seconds in the window (host clock,
  synchronized at both ends), each idle instant credited to the
  innermost program span over it, "(none)" outside every span (the
  benchmark's own code between jobs); they sum to `idle_s`. `idle_under`
  sums them inside each entry span and the Krylov loop, children
  included; `krylov_idle_ms` is that of `svd.krylov` over the Ritz steps,
  `sampler_idle_ms` that of `ldpred2.grid` over the sweeps;
- `gaps`: the ten longest idle gaps labelled as the benchmark's traced runs
  label them, then with the program span over their start; each with
  its seconds and their split by innermost span (the three largest);
- `spans`: each span's count, total and self milliseconds; `counters`
  the program's counters, `launches` the change in its launch counters,
  `depths` the Krylov depth of each PCA job;
- `draws`: the grid's draws a sweep, their time split into what their
  runtime calls spent blocked and the rest, the draws' own host work;
- `clock`: how far each `host.read` span lies from the
  `cudaMemcpyAsync` runtime call of its read (microseconds, 0 where the
  span encloses it): the program's clock against the profiler's.

No result line, no check: the numbers serve PERF.md. Exits 2 without a
CUDA device.
"""

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib import harness, program               # noqa: E402
from benchlib import spec as specs                  # noqa: E402
from benchlib.trace import SPAN, _raw_events, merge, summarize  # noqa: E402


def clock_offsets(records, events, slack_us=50.0):
    """For each `host.read` record, the runtime memcpy call that overlaps
    it most (within `slack_us`), and how far that call reaches outside
    the span: {reads, matched, max_offset_us}."""
    calls = sorted((s, e) for n, s, e, d in events
                   if not d and n.startswith("cudaMemcpy"))
    reads = [(r[1] / 1e3, r[2] / 1e3) for r in records
             if r[0] == "host.read"]
    worst, matched = 0.0, 0
    for s, e in reads:
        best = None
        for cs, ce in calls:
            if cs > e + slack_us:
                break
            if ce < s - slack_us:
                continue
            ov = min(e, ce) - max(s, cs)
            if best is None or ov > best[0]:
                best = (ov, cs, ce)
        if best is not None:
            matched += 1
            worst = max(worst, s - best[1], best[2] - e, 0.0)
    return {"reads": len(reads), "matched": matched,
            "max_offset_us": worst}


def labelled_gaps(idle, events, busy, parts, records):
    """`summarize`'s idle gaps (`idle`, its [label, seconds], longest
    first), each label followed by the program span over the gap's start,
    with the gap's three largest shares by innermost span. The gaps are
    found again as `summarize` finds them (the busy union's gaps over the
    span of every event, longest first), with `program.idle_gaps`:
    `summarize` gives no gap's start."""
    t0 = min(s for _, s, _, _ in events)
    t1 = max(e for _, _, e, _ in events)
    gaps = sorted(((e - s, s) for s, e in program.idle_gaps(busy, t0, t1)),
                  reverse=True)[:len(idle)]
    out = []
    for (lab, sec), (length, at) in zip(idle, gaps):
        split = program.by_name(program.idle_by_record(
            [], at, at + length, parts), records)
        top3 = sorted(split.items(), key=lambda kv: -kv[1])[:3]
        where = program.span_at(parts, records, at) or program.NONE
        out.append([f"{lab} / {where}", sec, dict(top3)])
    return out


def draw_cost(records, events):
    """The draws' time a sweep (`gibbs.draw` spans, which have no child
    spans, over `gibbs.sweep` spans): `draw_ms` in all, `blocked_ms` the
    part their runtime calls spent beyond the median call of the same name
    (a launch that finds the launch queue full waits there for the
    device), `own_ms` the rest, and `calls` their runtime calls; None
    without draws."""
    sweeps = sum(r[0] == "gibbs.sweep" for r in records)
    draws = [(r[1] / 1e3, r[2] / 1e3) for r in records
             if r[0] == "gibbs.draw"]
    if not sweeps or not draws:
        return None
    calls = sorted((s, e, n) for n, s, e, d in events if not d and e >= s)
    durs: dict = {}
    for cs, ce, n in calls:
        durs.setdefault(n, []).append(ce - cs)
    med = {n: statistics.median(v) for n, v in durs.items()}
    starts = [c[0] for c in calls]
    total = blocked = 0.0
    n_calls = 0
    for s, e in draws:
        total += e - s
        for cs, ce, n in calls[bisect.bisect_left(starts, s):
                               bisect.bisect_right(starts, e)]:
            n_calls += 1
            blocked += max(0.0, min(ce, e) - cs - med[n])
    return {"draw_ms": total / 1e3 / sweeps, "blocked_ms": blocked / 1e3
            / sweeps, "own_ms": (total - blocked) / 1e3 / sweeps,
            "calls": n_calls / sweeps}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    build = harness.set_caches(specs.ROOT)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(specs.ROOT))
    from bigsnpr_tpu_torch import config
    from bigsnpr_tpu_torch.utils.profiling import recording

    config.enable_compilation_cache(build)
    dev = torch.device("cuda", 0)
    spec = specs.benchmark()
    cw = specs.cell(spec, args.workload)
    traffic = specs.traffic(cw["traffic"])
    cellf = specs.cell_file(args.workload)
    job = specs.load_module("jobs", traffic["job"])
    ctx = harness.Ctx(args.workload, specs.config(spec, cw["config"]),
                      traffic, cellf, args.seed, dev)
    state = job.setup(ctx)
    ctx.sync()
    c0 = dict(job.counters(state))
    n_jobs = int(cellf.get("trace_jobs", 1))
    depths = []
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.time_ns()
            for i in range(n_jobs):
                res = job.run(state, ctx, i, harness.job_seed(args.seed, i))
                depths.append(int(res.get("niter", 0)))
            ctx.sync()
            w1 = time.time_ns()
    c1 = job.counters(state)
    events = _raw_events(prof, DeviceType)
    busy = merge([(s, e) for n, s, e, d in events
                  if d and e > s and not n.startswith(SPAN)])
    a, b = w0 / 1e3, w1 / 1e3
    busy_s = sum(min(e, b) - max(s, a) for s, e in busy
                 if e > a and s < b) / 1e6
    parts = program.pieces(rec.records)
    credit = program.idle_by_record(busy, a, b, parts)
    by_span = program.by_name(credit, rec.records)
    under = {k: program.under(credit, rec.records, k)
             for k in ("svd", "svd.krylov", "ldpred2.grid", "prodvec")
             if rec.n(k)}
    per = {"krylov_idle_ms": ("svd.krylov", "svd.ritz"),
           "sampler_idle_ms": ("ldpred2.grid", "gibbs.sweep")}
    line = {
        "cell": args.workload, "card": harness.card_info(),
        "jobs": n_jobs, "window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
        "idle_s": (w1 - w0) / 1e9 - busy_s,
        "idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        "idle_under": under,
        **{k: 1e3 * under[s] / rec.n(n) for k, (s, n) in per.items()
           if s in under and rec.n(n)},
        "gaps": labelled_gaps(summarize(events, top=10)["idle"], events,
                              busy, parts, rec.records),
        "draws": draw_cost(rec.records, events),
        "spans": {k: [v[0], v[1] / 1e6, v[2] / 1e6]
                  for k, v in sorted(rec.stats.items(),
                                     key=lambda kv: -kv[1][2])},
        "counters": rec.counters, "dropped": rec.dropped,
        "launches": {k: c1[k] - c0.get(k, 0) for k in c1
                     if c1[k] != c0.get(k, 0)},
        "depths": depths, "clock": clock_offsets(rec.records, events)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
