"""Profiling / tracing helpers (the reference has none, SURVEY.md §5).

`trace` wraps torch.profiler, as the JAX package's wraps jax.profiler:

    with trace("traces/autosvd"):
        snp_autoSVD(pack)

writes the host activity and, on CUDA, the device's as a Chrome trace
(`trace.json`, viewable in Perfetto or chrome://tracing). `StageTimer`
is a wall-time stage timer for long pipelines: stages end where their
results reach the host, so on CUDA the host clock around a stage includes
the device work it waited for."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace context; yields the profiler, whose
    `key_averages()` tabulates the ops, and writes `logdir/trace.json`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class StageTimer:
    """Accumulates per-stage wall times; results in .times (dict)."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v:.2f}s ({100*v/total:.0f}%)"
                 for k, v in sorted(self.times.items(), key=lambda x: -x[1])]
        return "\n".join(lines)
