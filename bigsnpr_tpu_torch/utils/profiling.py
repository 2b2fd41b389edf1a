"""Wall-time stage timer for long pipelines (`StageTimer` of
`bigsnpr_tpu/utils/profiling.py`; its `trace`, a wrapper of the JAX
profiler, has no counterpart here yet).

Stages end where their results reach the host, so on CUDA the host clock
around a stage includes the device work it waited for."""

from __future__ import annotations

import contextlib
import time


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
