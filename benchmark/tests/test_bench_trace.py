"""The trace summary on made-up events."""

import pytest

from benchlib.trace import merge, summarize


def test_merge():
    assert merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]


def test_summarize_busy_union_and_gaps():
    ev = [("bench.job", 0.0, 100.0, False),
          ("aten::item", 40.0, 60.0, False),
          ("k1", 0.0, 20.0, True), ("k2", 10.0, 30.0, True),
          ("k1", 70.0, 100.0, True),
          ("bench.job", 0.0, 100.0, True)]
    s = summarize(ev)
    assert s["busy_s"] == pytest.approx(60e-6)
    assert s["kernel_s"] == pytest.approx({"k1": 50e-6, "k2": 20e-6})
    assert s["kernel_n"] == {"k1": 2, "k2": 1}
    assert s["device_events"] == 3 and s["events"] == 6
    (label, gap), = s["idle"]
    assert gap == pytest.approx(40e-6)
    assert label == "bench.job"
    # a host op that covers the gap's start names it
    ev.append(("aten::copy_", 29.0, 35.0, False))
    assert summarize(ev)["idle"][0][0] == "bench.job / aten::copy_"


def test_a_gap_without_a_covering_host_event_names_the_next_call():
    ev = [("k1", 0.0, 10.0, True), ("cudaLaunchKernel", 25.0, 26.0, False),
          ("k2", 30.0, 40.0, True)]
    (label, gap), = summarize(ev)["idle"]
    assert label == "until cudaLaunchKernel"
    assert gap == pytest.approx(20e-6)


def test_summarize_without_device_events():
    s = summarize([("bench.job", 0.0, 10.0, False)])
    assert s["busy_s"] == 0 and s["device_events"] == 0
    assert s["idle"][0][1] == pytest.approx(10e-6)
