"""Profiling / tracing helpers (the reference has none, SURVEY.md §5).

The recorder. `span(name)` marks a stretch of the port's host code and
`count(name, k)` counts where the work happens:

    with recording() as rec:
        bed_randomSVD(pack, k=20)
    rec.stats["svd.ritz"]       # [count, total ns, self ns]
    rec.counters["host_reads"]

While a recorder is on, each span is kept as [name, start_ns, end_ns,
parent, call] (parent: the index of the enclosing span's record, call:
that of the outermost one, -1 for none) on `time.time_ns()`'s clock,
which is the clock of kineto's event stamps: a span lines up with the
kernels and runtime calls of a torch.profiler trace taken around it. A
recorder is on inside `recording()`, and while a torch.profiler session
runs outside one: those spans go to a recorder of the session's own, kept
to `PROFILED_CAP` records, that `take_profiled()` hands over, so that
whoever profiled the program reads its spans beside the profiler's events
(a span that finds the profiler off ends the session's recorder; two
sessions with no span between share one). Spans nest per thread: a span
opened on another thread starts a call of its own. Otherwise `span` returns a
shared no-op object (no clock read, no allocation) and `count` returns
at once. `to_host(t)` is the port's read of a device tensor on the host,
counted as `host_reads` / `host_read_bytes` under a `host.read` span.

`trace` wraps torch.profiler, as the JAX package's wraps jax.profiler:

    with trace("traces/autosvd"):
        snp_autoSVD(pack)

writes the host activity and, on CUDA, the device's as a Chrome trace
(`trace.json`, viewable in Perfetto or chrome://tracing), with the
program's spans on a track of their own. `StageTimer` is a wall-time
stage timer for long pipelines: stages end where their results reach
the host, so on CUDA the host clock around a stage includes the device
work it waited for."""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from pathlib import Path

import torch

# the most span records a recorder keeps; later spans count in `stats`
# and `dropped` only
CAP = 1 << 20
# the cap of the recorder of a torch.profiler session outside `recording()`
PROFILED_CAP = 1 << 16

# torch.profiler sets its `_is_profiler_enabled` while a session runs
_autograd_profiler = torch.autograd.profiler


class Recorder:
    """The spans and counters of one recording.

    records: [name, start_ns, end_ns, parent, call] of the first `cap`
        spans in the order they opened; `dropped` counts the rest.
    stats: name -> [count, total_ns, self_ns] over every span, self time
        being a span's duration less the time its child spans cover.
    counters: name -> total of `count(name, k)`."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.records: list = []
        self.dropped = 0
        self.stats: dict = {}
        self.counters: dict = {}
        self._local = threading.local()    # .top: a thread's innermost span

    def count(self, name: str, k=1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k

    def n(self, name: str) -> int:
        """How many `name` spans closed."""
        return self.stats.get(name, (0, 0, 0))[0]

    def total_ms(self, name: str) -> float:
        return self.stats.get(name, (0, 0, 0))[1] / 1e6

    def self_ms(self, name: str) -> float:
        return self.stats.get(name, (0, 0, 0))[2] / 1e6


class _Named:
    """What `span` returns: a context manager that, used as a decorator,
    opens `span(name)` around each call."""

    __slots__ = ("name",)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Noop(_Named):
    __slots__ = ()

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Live(_Named):
    __slots__ = ("rec", "idx", "call", "up", "child", "t0")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec, loc = self.rec, self.rec._local
        self.up = up = getattr(loc, "top", None)
        loc.top = self
        self.child = 0
        if len(rec.records) < rec.cap:
            self.idx = len(rec.records)
            self.call = self.idx if up is None else up.call
            rec.records.append([self.name, 0, 0,
                                -1 if up is None else up.idx, self.call])
        else:
            self.idx, self.call = -1, -1 if up is None else up.call
            rec.dropped += 1
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec, dur = self.rec, t1 - self.t0
        if self.idx >= 0:
            r = rec.records[self.idx]
            r[1], r[2] = self.t0, t1
        st = rec.stats.get(self.name)
        if st is None:
            st = rec.stats[self.name] = [0, 0, 0]
        st[0] += 1
        st[1] += dur
        st[2] += dur - self.child
        if self.up is not None:
            self.up.child += dur
        rec._local.top = self.up
        return False


_active: Recorder | None = None     # the recorder `recording()` turned on
_profiled: Recorder | None = None   # spans under torch.profiler, untaken
_fresh = True       # the next span under torch.profiler starts a recorder
_noops: dict = {}


def _current() -> Recorder | None:
    global _profiled, _fresh
    if _active is not None:
        return _active
    if _autograd_profiler._is_profiler_enabled:
        if _fresh:
            _profiled, _fresh = Recorder(PROFILED_CAP), False
        return _profiled
    _fresh = True
    return None


def span(name: str):
    """A span named `name`: a context manager, or a decorator that opens
    it around each call of the function."""
    rec = _current()
    if rec is None:
        noop = _noops.get(name)
        if noop is None:
            noop = _noops[name] = _Noop(name)
        return noop
    return _Live(rec, name)


def count(name: str, k=1) -> None:
    """Adds k to the counter `name` while a recorder is on."""
    rec = _current()
    if rec is not None:
        rec.count(name, k)


def to_host(t: torch.Tensor):
    """t as a numpy array on the host: a synchronizing copy from a device
    tensor. Counted as one `host_reads` of `host_read_bytes`, inside a
    `host.read` span, while a recorder is on."""
    rec = _current()
    if rec is None:
        return t.cpu().numpy()
    with _Live(rec, "host.read"):
        rec.count("host_reads")
        rec.count("host_read_bytes", t.numel() * t.element_size())
        return t.cpu().numpy()


@contextlib.contextmanager
def recording(cap: int = CAP):
    """Turns a new recorder on for the block and yields it; the recorder
    that was on before (if any) is on again after."""
    global _active
    prev, rec = _active, Recorder(cap)
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


def take_profiled() -> Recorder | None:
    """The recorder of the spans made under the latest torch.profiler
    session outside `recording()`, if not taken yet (else None); the next
    such span starts a new one."""
    global _profiled, _fresh
    rec, _profiled, _fresh = _profiled, None, True
    return rec


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace context with the recorder on; yields the
    profiler, whose `key_averages()` tabulates the ops, and writes
    `logdir/trace.json` with the program's spans on their own track."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    path = Path(logdir) / "trace.json"
    with recording() as rec:
        prof.start()
        try:
            yield prof
        finally:
            prof.stop()
            prof.export_chrome_trace(str(path))
            _add_spans(path, rec)


def _add_spans(path: Path, rec: Recorder) -> None:
    """Appends the recorder's spans to a Chrome trace as complete events
    of a "program spans" process, on the trace's time base (microseconds
    from `baseTimeNanoseconds`, where the trace has one)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = "program spans"
    ev = doc.setdefault("traceEvents", [])
    ev.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": pid}})
    ev.append({"ph": "M", "name": "process_sort_index", "pid": pid,
               "tid": 0, "args": {"sort_index": -1}})
    for name, s, e, parent, call in rec.records:
        ev.append({"ph": "X", "cat": "program", "name": name, "pid": pid,
                   "tid": 0, "ts": (s - base) / 1e3, "dur": (e - s) / 1e3,
                   "args": {"parent": parent, "call": call}})
    with open(path, "w") as f:
        json.dump(doc, f)


class StageTimer:
    """Accumulates per-stage wall times; results in .times (dict). Each
    stage is also a `stage.<name>` span."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(f"stage.{name}"):
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
