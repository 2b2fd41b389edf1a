"""The device's work over the traced window, from torch.profiler.

`DeviceTrace` profiles whole jobs, then keeps only a summary: each
device operation's time by name, the union of the device's busy
intervals, and the longest idle gaps with what the host was doing then:
the innermost host event covering the gap's start (on the card a CUDA
runtime call, such as a synchronize; and the benchmark's own `bench.*`
span where the profiler records host ops), else the first runtime call
the host made in the gap ("until cudaLaunchKernel": the host was busy
with its own work until it launched again). No Chrome trace is written.
"""

from __future__ import annotations

import time

SPAN = "bench."     # the benchmark's own record_function spans


def _raw_events(prof, DeviceType):
    """(name, start_us, end_us, on_device) of every event. The kineto
    results are read directly: building the profiler's event tree for a
    few hundred thousand events takes longer than the run."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            s, d = float(e.start_us()), float(e.duration_us())
        out.append((e.name(), s, s + d, e.device_type() == DeviceType.CUDA))
    return out


def merge(intervals):
    """Sorted, merged (start, end) intervals of [(start, end), ...]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, top: int = 10) -> dict:
    """Device time by operation name, the busy union and the idle gaps of
    `events` [(name, start_us, end_us, on_device)]. The profiler mirrors
    the benchmark's `bench.*` spans onto the device's timeline as
    annotations; they are no device work and are left out."""
    dev = [(n, s, e) for n, s, e, d in events
           if d and e > s and not n.startswith(SPAN)]
    host = sorted((s, e, n) for n, s, e, d in events if not d and e >= s)
    by_name: dict = {}
    counts: dict = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        counts[n] = counts.get(n, 0) + 1
    busy = merge([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    # the span of the trace: every event, host and device
    starts = [s for _, s, _, _ in events]
    ends = [e for _, _, e, _ in events]
    t0, t1 = (min(starts), max(ends)) if events else (0.0, 0.0)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[2 * i + 1] - edges[2 * i], edges[2 * i])
                   for i in range(len(edges) // 2)
                   if edges[2 * i + 1] > edges[2 * i]), reverse=True)[:top]
    idle = []
    for length, at in gaps:
        inner, span, after = None, None, None
        for s, e, n in host:
            if s > at:
                if s < at + length and after is None:
                    after = n
                if span is not None or inner is not None or s >= at + length:
                    break
                continue
            if e >= at:
                if n.startswith(SPAN) and (span is None or s >= span[0]):
                    span = (s, n)
                elif not n.startswith(SPAN) and (inner is None
                                                  or s >= inner[0]):
                    inner = (s, n)
        label = " / ".join(x[1] for x in (span, inner) if x)
        if not label:
            label = f"until {after}" if after else "no host event"
        idle.append([label[:160], length / 1e6])
    return {"kernel_s": by_name, "kernel_n": counts, "busy_s": busy_s,
            "events": len(events), "device_events": len(dev), "idle": idle}


class DeviceTrace:
    """Context manager: profiles the jobs run inside it. After exit,
    `span_s` is the host clock's length of the window (synchronised at
    both ends) and `summary` the `summarize` of its events."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.summary, self.span_s = None, 0.0

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        # on the card, CUDA activity alone (kernels, copies and the runtime
        # calls that launch them): recording every host op as well slows
        # the host-bound sampler driver by half again
        acts = ([ProfilerActivity.CUDA] if self.dev.type == "cuda"
                else [ProfilerActivity.CPU])
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.span_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            from torch.autograd import DeviceType

            self.summary = summarize(_raw_events(self.prof, DeviceType))
        self.prof = None
        return False

    def kernel_s(self, substr: str) -> float:
        return sum(v for k, v in self.summary["kernel_s"].items()
                   if substr in k)

    def kernel_n(self, substr: str) -> int:
        return sum(v for k, v in self.summary["kernel_n"].items()
                   if substr in k)
