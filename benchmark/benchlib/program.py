"""The program's own spans and counters in a traced window.

bigsnpr_tpu_torch records spans (`utils/profiling.py`) while a recorder
is on, and keeps those made under a torch.profiler session outside an
explicit recording for `take_profiled()`. `recorder(rec)` takes that
recording once for the traced window and keeps it on the trace as
`tr.program`, for every per-layer reader of the window. A program that
records no spans (an older checkout) leaves it None, and so do a window
without a trace or one in which nothing ran on the device: a CPU run
times the kernels' plain twins, not the program on the card.

The spans are stamped with `time.time_ns()`, the clock of kineto's
events, so they line up with the device trace: `pieces` cuts a window
into the innermost span over each instant, `idle_by_record` credits each
idle instant of the device to it, and `by_name` and `under` sum that by
span name and over a span's children (`benchmark/spans.py`).
"""

from __future__ import annotations

import bisect

NONE = "(none)"     # idle time outside every program span


def recorder(rec):
    """The program's recorder of the traced window, or None."""
    tr = rec.get("trace")
    if tr is None or not tr.summary or tr.summary["device_events"] == 0:
        return None
    if not hasattr(tr, "program"):
        try:
            from bigsnpr_tpu_torch.utils.profiling import take_profiled
        except ImportError:
            tr.program = None
        else:
            tr.program = take_profiled()
        if tr.program is not None:
            top = sorted(tr.program.stats.items(), key=lambda kv: -kv[1][2])
            rec["log"]("program spans, self ms (count): " + ", ".join(
                f"{k} {v[2] / 1e6:.3f} ({v[0]})" for k, v in top[:12]))
    return tr.program


def per_job(rec, value):
    """value over the window's jobs, None without jobs."""
    return value / rec["jobs"] if rec["jobs"] else None


def pieces(records):
    """Disjoint (start_us, end_us, i) pieces of the spans' time, each
    instant given to the innermost span over it, i its index in records,
    the recorder's [name, start_ns, end_ns, parent, call] nested as spans
    of one thread nest (a child that outlasts its parent is cut at the
    parent's end)."""
    out, stack = [], []           # stack: [index, end, cursor]

    def close():
        i, end, cur = stack.pop()
        if end > cur:
            out.append((cur, end, i))
        if stack:
            stack[-1][2] = max(stack[-1][2], end)

    for i, s, e in sorted(((i, r[1] / 1e3, r[2] / 1e3)
                           for i, r in enumerate(records)),
                          key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            close()
        if stack:
            top = stack[-1]
            e = min(e, top[1])
            if s > top[2]:
                out.append((top[2], s, top[0]))
            top[2] = max(top[2], s)
        stack.append([i, e, s])
    while stack:
        close()
    return sorted(out)


def idle_gaps(busy, t0, t1):
    """The (start, end) gaps of [t0, t1] outside the merged, sorted busy
    intervals."""
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


def idle_by_record(busy, t0, t1, parts) -> dict:
    """Seconds of the device's idle time in [t0, t1] (microseconds; busy
    the merged intervals) by the record of the innermost program span over
    each idle instant (`pieces`), None for the rest."""
    out: dict = {}
    starts = [p[0] for p in parts]
    for gs, ge in idle_gaps(busy, t0, t1):
        covered = 0.0
        j = max(bisect.bisect_right(starts, gs) - 1, 0)
        while j < len(parts) and parts[j][0] < ge:
            s, e = max(parts[j][0], gs), min(parts[j][1], ge)
            if e > s:
                out[parts[j][2]] = out.get(parts[j][2], 0.0) + (e - s) / 1e6
                covered += e - s
            j += 1
        if ge - gs > covered:
            out[None] = out.get(None, 0.0) + (ge - gs - covered) / 1e6
    return out


def by_name(credit, records) -> dict:
    """`idle_by_record`'s seconds summed by span name, NONE for None:
    `idle_by_span`. Sums to the idle time."""
    out: dict = {}
    for i, sec in credit.items():
        k = NONE if i is None else records[i][0]
        out[k] = out.get(k, 0.0) + sec
    return out


def under(credit, records, name) -> float:
    """`idle_by_record`'s seconds inside `name` spans, their children's
    included."""
    def inside(i):
        while i >= 0:
            if records[i][0] == name:
                return True
            i = records[i][3]
        return False

    return sum(sec for i, sec in credit.items()
               if i is not None and inside(i))


def span_at(parts, records, t):
    """The name of the innermost program span over instant t, or None."""
    j = bisect.bisect_right([p[0] for p in parts], t) - 1
    if j >= 0 and parts[j][0] <= t < parts[j][1]:
        return records[parts[j][2]][0]
    return None
