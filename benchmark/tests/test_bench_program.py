"""The program's spans in a traced window: crediting the device's idle
time to them, and the readers of the program's spans and counters, on
made-up spans and recorders."""

import types

import pytest

from benchlib import program

NS = 1000   # records are in nanoseconds, the trace in microseconds


def rec_of(*spans):
    """[name, start_ns, end_ns, parent, call] from (name, start_us,
    end_us); parents are not read."""
    return [[n, s * NS, e * NS, -1, 0] for n, s, e in spans]


def test_pieces_give_each_instant_to_the_innermost_span():
    records = rec_of(("job", 0, 100), ("a", 10, 40), ("b", 20, 30),
                     ("a", 50, 60), ("other", 120, 130))
    assert program.pieces(records) == [
        (0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 40, 1), (40, 50, 0),
        (50, 60, 3), (60, 100, 0), (120, 130, 4)]
    parts = program.pieces(records)
    assert program.span_at(parts, records, 25) == "b"
    assert program.span_at(parts, records, 110) is None
    # a child that outlasts its parent is cut at the parent's end
    assert program.pieces(rec_of(("p", 0, 10), ("c", 5, 15))) == [
        (0, 5, 0), (5, 10, 1)]


def test_idle_by_span_sums_to_the_idle_time():
    records = rec_of(("job", 0, 100), ("a", 10, 40), ("b", 20, 30))
    records[1][3], records[2][3] = 0, 1       # job > a > b
    busy = [[0, 15], [25, 35], [90, 95]]
    credit = program.idle_by_record(busy, 0, 120, program.pieces(records))
    out = program.by_name(credit, records)
    # idle: 15-25 (a 15-20, b 20-25), 35-90 (a 35-40, job 40-90),
    # 95-120 (job 95-100, none 100-120)
    assert out == pytest.approx({"a": 10e-6, "b": 5e-6, "job": 55e-6,
                                 program.NONE: 20e-6})
    idle = sum(e - s for s, e in program.idle_gaps(busy, 0, 120)) / 1e6
    assert sum(out.values()) == pytest.approx(idle) == pytest.approx(90e-6)
    # inside a span, its children's idle time included
    assert program.under(credit, records, "a") == pytest.approx(15e-6)
    assert program.under(credit, records, "job") == pytest.approx(70e-6)
    assert program.under(credit, records, "none") == 0
    assert program.by_name(program.idle_by_record([], 0, 10, []), []) == {
        program.NONE: pytest.approx(10e-6)}
    assert program.idle_gaps([[0, 5], [3, 12]], 0, 10) == []


class Trace:
    def __init__(self, device_events=1, prog=None):
        self.summary = {"device_events": device_events}
        if prog is not None:
            self.program = prog


def recorder(stats=None, counters=None):
    return types.SimpleNamespace(
        stats=stats or {}, counters=counters or {},
        n=lambda k: (stats or {}).get(k, (0, 0, 0))[0],
        total_ms=lambda k: (stats or {}).get(k, (0, 0, 0))[1] / 1e6,
        self_ms=lambda k: (stats or {}).get(k, (0, 0, 0))[2] / 1e6)


def run(name, rec):
    from benchlib import spec as specs

    return specs.load_module("metrics", name).read(rec)


READERS = ["scaling_ms", "ritz_host_ms", "op_cache_hit_pct",
           "host_reads_per_job"]


def test_readers_on_a_made_up_recorder():
    prog = recorder(
        stats={"svd.scaling": [2, 6e9, 5e9], "svd.ritz": [50, 2e9, 5e8],
               "gibbs.sweep": [300, 9e9, 1e9]},
        counters={"svd.op_cache_hit": 3, "svd.op_build": 1,
                  "host_reads": 62})
    rec = {"trace": Trace(prog=prog), "jobs": 2, "log": print}
    got = {k: run(k, rec) for k in READERS}
    assert got == pytest.approx({"scaling_ms": 3000.0, "ritz_host_ms": 10.0,
                                 "op_cache_hit_pct": 75.0,
                                 "host_reads_per_job": 31.0})


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_their_spans(name):
    for rec in ({"trace": None, "jobs": 1, "log": print},
                {"trace": Trace(device_events=0, prog=recorder()),
                 "jobs": 1, "log": print},
                {"trace": Trace(prog=recorder()), "jobs": 1, "log": print}):
        assert run(name, rec) is None


def test_the_window_takes_the_programs_profiled_spans():
    """Spans made under torch.profiler reach the readers once, kept on
    the trace; a trace with no device events takes nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigsnpr_tpu_torch.utils.profiling import count, span, take_profiled

    take_profiled()
    lines = []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("svd.ritz"):
            torch.ones(3).sum()
        count("host_reads", 4)
    rec = {"trace": Trace(), "jobs": 2, "log": lines.append}
    assert not hasattr(rec["trace"], "program")
    assert run("host_reads_per_job", rec) == 2.0
    assert run("ritz_host_ms", rec) > 0
    assert rec["trace"].program.n("svd.ritz") == 1
    assert len(lines) == 1 and "svd.ritz" in lines[0]
    assert take_profiled() is None
    assert program.recorder({"trace": Trace(device_events=0)}) is None


def test_spans_labels_the_gaps_summarize_finds():
    """`spans.py` labels the gaps `summarize` finds, longest first, with
    the innermost program span over each gap's start."""
    import spans
    from benchlib.trace import merge, summarize

    records = rec_of(("job", 0, 100), ("read", 10, 20), ("host", 20, 60))
    events = [("k1", 0, 10, True), ("k2", 60, 70, True),
              ("k3", 95, 100, True), ("cudaMemcpyAsync", 10, 19, False)]
    busy = merge([(s, e) for _, s, e, d in events if d])
    idle = summarize(events, top=10)["idle"]
    got = spans.labelled_gaps(idle, events, busy, program.pieces(records),
                              records)
    assert [g[1] for g in got] == [g[1] for g in idle] == pytest.approx(
        [50e-6, 25e-6])
    assert got[0][0] == idle[0][0] + " / read"
    assert got[0][2] == pytest.approx({"host": 40e-6, "read": 10e-6})
    assert got[1][0].endswith(" / job")


def test_spans_splits_the_draws_into_blocked_and_own_time():
    """A draw's runtime call that lasts past the median call of its name
    counts the excess as blocked; the rest of the draws' time is their
    own."""
    import spans

    records = rec_of(("gibbs.sweep", 0, 100), ("gibbs.draw", 0, 40),
                     ("gibbs.sweep", 100, 200), ("gibbs.draw", 100, 110))
    events = [("cudaLaunchKernel", s, s + 2, False) for s in (1, 5, 101)]
    events += [("cudaLaunchKernel", 10, 35, False),     # blocked 23 us
               ("k", 0, 300, True)]
    got = spans.draw_cost(records, events)
    assert got == pytest.approx({"draw_ms": 25e-3, "blocked_ms": 11.5e-3,
                                 "own_ms": 13.5e-3, "calls": 2.0})
    assert spans.draw_cost(rec_of(("gibbs.sweep", 0, 1)), events) is None
