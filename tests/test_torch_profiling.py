"""The port's recorder (utils/profiling.py): spans, counters and host
reads, on the CPU. Imports only torch and the port.

Nesting, parents, calls, self time and the record cap on made-up spans;
the off path; the clock against kineto's events; and the spans and
counts that randomSVD, LDpred2-grid, LDpred2-auto, snp_prodVec and the
operator leave, against the depths, sweeps and host reads of the call."""

import json
import time

import numpy as np
import pytest
import torch

import bigsnpr_tpu_torch as pt
from bigsnpr_tpu_torch.core import unpack
from bigsnpr_tpu_torch.ops.geno_kernels import GenoOperator
from bigsnpr_tpu_torch.utils import profiling
from bigsnpr_tpu_torch.utils.profiling import (StageTimer, count, recording,
                                               span, take_profiled, to_host)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pt.config.options(device="cpu"):
        yield


def structured_pack(n=240, m=400, seed=0):
    """Three populations with distinct allele frequencies, 2% NA."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, 3, n)
    p = np.clip(rng.uniform(0.1, 0.5, m)[:, None]
                + rng.normal(0, 0.12, (m, 3)), 0.02, 0.98)
    X = rng.binomial(2, p[:, pop]).astype(float)          # (m, n)
    X[rng.random((m, n)) < 0.02] = np.nan
    return pt.GenoPack(packed=unpack.np_pack_codes(
        unpack.np_dosage_to_codes(X)), n=n)


@pytest.fixture(scope="module")
def ld_pipe():
    """A haplotype-copying cohort of 1,000 x 300, its GWAS and LD."""
    rng = np.random.default_rng(42)
    n, m = 1000, 300
    p = rng.uniform(0.1, 0.5, m)
    hap = np.empty((2 * n, m), dtype=np.int8)
    hap[:, 0] = rng.random(2 * n) < p[0]
    for j in range(1, m):
        copy = rng.random(2 * n) < 0.8
        hap[:, j] = np.where(copy, hap[:, j - 1], rng.random(2 * n) < p[j])
    X = (hap[:n] + hap[n:]).astype(float)
    Xs = (X - X.mean(0)) / X.std(0)
    beta = np.zeros(m)
    causal = rng.choice(m, 30, replace=False)
    beta[causal] = rng.normal(0, np.sqrt(0.5 / 30), 30)
    g = Xs @ beta
    y = g + rng.normal(0, np.sqrt(1 - g.var()), n)
    yc = y - y.mean()
    b = Xs.T @ yc / n
    se = np.sqrt(((yc[:, None] - Xs * b) ** 2).sum(0) / (n - 2) / n)
    pack = pt.GenoPack(packed=unpack.np_pack_codes(
        unpack.np_dosage_to_codes(X.T)), n=n)
    with pt.config.options(device="cpu"):
        corr = pt.snp_cor(pack, size=50)
    return dict(pack=pack, corr=corr, blocks=pt.auto_blocks(corr,
                                                            max_block=100),
                df={"beta": b, "beta_se": se, "n_eff": np.full(m, float(n))})


def test_spans_nest_with_parent_call_and_self_time():
    with recording() as rec:
        with span("a"):
            with span("b"):
                time.sleep(0.002)
            with span("b"):
                with span("c"):
                    time.sleep(0.001)
        with span("d"):
            pass
    names = [r[0] for r in rec.records]
    assert names == ["a", "b", "b", "c", "d"]
    parents = [r[3] for r in rec.records]
    calls = [r[4] for r in rec.records]
    assert parents == [-1, 0, 0, 2, -1]
    assert calls == [0, 0, 0, 0, 4]
    for name, s, e, parent, _ in rec.records:
        assert s <= e
        if parent >= 0:
            ps, pe = rec.records[parent][1:3]
            assert ps <= s and e <= pe
    dur = [e - s for _, s, e, _, _ in rec.records]
    assert rec.stats["a"] == [1, dur[0], dur[0] - dur[1] - dur[2]]
    assert rec.stats["b"] == [2, dur[1] + dur[2], dur[1] + dur[2] - dur[3]]
    assert rec.stats["c"] == [1, dur[3], dur[3]]
    assert rec.n("b") == 2 and rec.n("none") == 0
    assert rec.total_ms("c") == pytest.approx(dur[3] / 1e6)
    assert rec.self_ms("a") >= 0 and rec.dropped == 0
    assert profiling._active is None


def test_the_record_cap_keeps_the_stats():
    with recording(cap=3) as rec:
        for _ in range(2):
            with span("outer"):
                with span("inner"):
                    count("k", 2)
        with span("outer"):
            pass
    assert len(rec.records) == 3 and rec.dropped == 2
    assert rec.n("outer") == 3 and rec.n("inner") == 2
    assert rec.counters == {"k": 4}
    # the dropped inner span's parent record was kept; its call is known
    assert [r[0] for r in rec.records] == ["outer", "inner", "outer"]


def test_the_off_path_records_and_counts_nothing():
    take_profiled()                       # whatever an earlier profiler left
    a = span("x")
    assert span("x") is a                 # shared, nothing allocated
    with a as entered:
        count("host_reads", 5)
    assert entered is a
    t = torch.arange(6.0)
    np.testing.assert_array_equal(to_host(t), np.arange(6.0))
    with recording() as rec:
        pass
    assert rec.records == [] and rec.counters == {} and rec.stats == {}
    assert take_profiled() is None


def test_span_as_a_decorator_opens_one_span_a_call():
    @span("f")
    def f(x):
        with span("g"):
            return x + 1

    assert f(1) == 2                      # off: a plain call
    with recording() as rec:
        assert f(2) == 3 and f(3) == 4
    assert rec.n("f") == 2 and rec.n("g") == 2
    assert [r[3] for r in rec.records] == [-1, 0, -1, 2]
    assert f.__name__ == "f"


def test_recordings_nest_and_restore():
    with recording() as outer:
        with span("a"):
            with recording() as inner:
                with span("b"):
                    pass
        with span("c"):
            pass
    assert [r[0] for r in outer.records] == ["a", "c"]
    assert [r[0] for r in inner.records] == ["b"]


def test_spans_share_the_profilers_clock():
    """A span around a matmul encloses kineto's aten::mm event within
    1 ms; spans under torch.profiler go to `take_profiled`."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    take_profiled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mm"):
            a @ a
        count("c")
    rec = take_profiled()
    assert rec is not None and take_profiled() is None
    assert rec.counters == {"c": 1}
    (_, s, e, _, _), = rec.records
    mm = [ev for ev in prof.profiler.kineto_results.events()
          if ev.name() == "aten::mm"]
    assert len(mm) == 1
    ms, me = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert s - 1_000_000 <= ms and me <= e + 1_000_000
    assert ms - s < 1_000_000 and e - me < 1_000_000
    # an explicit recorder wins over the profiler's
    with profile(activities=[ProfilerActivity.CPU]):
        with recording() as rec2:
            with span("x"):
                pass
    assert rec2.n("x") == 1 and take_profiled() is None


def test_each_profiler_session_starts_a_capped_recorder():
    """An untaken session's spans do not pile into the next session's
    recorder once a span has found the profiler off between them."""
    from torch.profiler import ProfilerActivity, profile

    take_profiled()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("first"):
            pass
    with span("between"):                 # off: ends the session's recorder
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
        count("k")
    rec = take_profiled()
    assert [r[0] for r in rec.records] == ["second"]
    assert rec.counters == {"k": 1} and rec.n("first") == 0
    assert rec.cap == profiling.PROFILED_CAP < profiling.CAP
    assert take_profiled() is None


def test_spans_nest_per_thread():
    """A span opened on another thread while one is open here is no
    child of it, and does not take this thread's next child."""
    import threading

    with recording() as rec:
        with span("main"):
            opened, done = threading.Event(), threading.Event()

            def work():
                with span("worker"):
                    opened.set()
                    done.wait(5)

            th = threading.Thread(target=work)
            th.start()
            opened.wait(5)
            with span("child"):
                pass
            done.set()
            th.join()
    by = {r[0]: r for r in rec.records}
    assert by["worker"][3] == -1
    assert by["worker"][4] == rec.records.index(by["worker"])
    assert by["child"][3] == 0 and by["child"][4] == 0
    assert rec.stats["main"][2] == rec.stats["main"][1] - rec.stats[
        "child"][1]


def test_randomsvd_spans_a_depth_and_a_power_step(monkeypatch):
    calls = []
    power_dev = GenoOperator.power_dev

    def counted(self, V):
        calls.append(V.shape[1])
        return power_dev(self, V)

    monkeypatch.setattr(GenoOperator, "power_dev", counted)
    pack = structured_pack()
    with recording() as rec:
        svd = pt.bed_randomSVD(pack, k=3, tol=1e-4)
    assert svd.niter >= 2
    assert rec.n("svd") == 1 and rec.n("svd.krylov") == 1
    assert rec.n("svd.ritz") == svd.niter
    assert rec.n("svd.power") == len(calls)
    # stopped by its tolerance: a power step and a Ritz step a depth
    assert len(calls) == svd.niter
    assert rec.n("svd.newdirs") == rec.n("svd.update") == svd.niter - 1
    assert rec.n("svd.scaling") == rec.n("svd.operator") == 1
    assert rec.n("svd.finish") == 1
    assert rec.counters["svd.op_build"] == 1 and rec.n("svd.op_build") == 1
    assert "svd.op_cache_hit" not in rec.counters
    # host reads: the counts, one Gram corner a depth, then G, u and v
    assert rec.counters["host_reads"] == svd.niter + 4
    assert rec.n("host.read") == svd.niter + 4
    m, n, k = pack.m, pack.n, 3
    G = sum(((k + 10) * d) ** 2 for d in range(1, svd.niter + 1))
    assert rec.counters["host_read_bytes"] == 4 * (
        4 * m + G + ((k + 10) * svd.niter) ** 2 + n * k + m * k)
    # every span of the call shares its id
    assert {r[4] for r in rec.records} == {0}
    # each svd.ritz holds its host read, which its self time leaves out
    ritz = [i for i, r in enumerate(rec.records) if r[0] == "svd.ritz"]
    assert all([r[0] for r in rec.records if r[3] == i] == ["host.read"]
               for i in ritz)
    with recording() as rec2:
        pt.bed_randomSVD(pack, k=3, tol=1e-4)
    assert rec2.counters["svd.op_cache_hit"] == 1
    assert "svd.op_build" not in rec2.counters


def test_ldpred2_grid_spans_a_sweep(ld_pipe):
    grid = {"p": [0.01, 0.1, 0.3], "h2": [0.3, 0.3, 0.5],
            "sparse": [False, True, False]}
    burn_in, num_iter = 3, 5
    with recording() as rec:
        beta = pt.snp_ldpred2_grid(ld_pipe["corr"], ld_pipe["df"], grid,
                                   burn_in=burn_in, num_iter=num_iter,
                                   blocks=ld_pipe["blocks"], seed=3)
    assert beta.shape == (300, 3)
    sweeps = burn_in + num_iter
    assert rec.n("ldpred2.grid") == 1
    assert rec.n("gibbs.sweep") == sweeps
    assert rec.n("gibbs.draw") == rec.n("gibbs.kernel") == sweeps
    assert rec.n("ldpred2.setup") == 2 and rec.n("ldpred2.to_host") == 1
    assert rec.counters["host_reads"] == 1
    assert rec.counters["host_read_bytes"] == 8 * 300 * 3
    draws = [r for r in rec.records if r[0] == "gibbs.draw"]
    assert all(rec.records[r[3]][0] == "gibbs.sweep" for r in draws)
    with recording() as rec2:
        pred = pt.snp_prodVec(ld_pipe["pack"], np.nan_to_num(beta))
    assert pred.shape == (1000, 3)
    assert rec2.n("prodvec") == 1 and rec2.counters["host_reads"] == 1
    assert [r[0] for r in rec2.records] == ["prodvec", "host.read"]


def test_ldpred2_auto_spans_the_driver_stages(ld_pipe):
    burn_in, num_iter = 2, 3
    with recording() as rec:
        pt.snp_ldpred2_auto(ld_pipe["corr"], ld_pipe["df"], 0.3,
                            vec_p_init=[0.01, 0.1], burn_in=burn_in,
                            num_iter=num_iter, blocks=ld_pipe["blocks"],
                            seed=4)
    sweeps = burn_in + num_iter
    for name in ("auto.sweep", "auto.update", "gibbs.draw", "gibbs.kernel",
                 "auto.sums", "auto.p", "auto.mle"):
        assert rec.n(name) == sweeps, name
    assert rec.n("gibbs.sweep") == 0
    parent = {r[0]: rec.records[r[3]][0] for r in rec.records
              if r[0] in ("auto.sums", "auto.p", "auto.mle", "gibbs.draw",
                          "gibbs.kernel")}
    assert parent == {"auto.sums": "auto.update", "auto.p": "auto.update",
                      "auto.mle": "auto.update", "gibbs.draw": "auto.sweep",
                      "gibbs.kernel": "auto.sweep"}


def test_host_reads_count_the_to_host_sites():
    pack = structured_pack(60, 50, seed=2)
    op = GenoOperator(pack, np.full(50, 1.0), np.full(50, 0.5))
    rng = np.random.default_rng(0)
    with recording() as rec:
        pt.snp_counts(pack)
        pt.snp_cprodVec(pack, rng.standard_normal(60))
        pt.snp_prodVec(pack, rng.standard_normal(50))
        op.cprod(rng.standard_normal((60, 2)))
        op.prod(rng.standard_normal((50, 2)))
        op.power(rng.standard_normal((60, 2)))
    assert rec.counters["host_reads"] == 7 == rec.n("host.read")
    assert rec.counters["host_read_bytes"] == 4 * (
        4 * 50 + 50 + 60 + 50 * 2 + 60 * 2 + 50 * 2 + 60 * 2)


def test_stage_timer_opens_a_span_a_stage():
    timer = StageTimer()
    with recording() as rec:
        with timer.stage("maf"):
            pass
        with timer.stage("maf"):
            pass
    with timer.stage("svd"):
        pass
    assert set(timer.times) == {"maf", "svd"}
    assert rec.n("stage.maf") == 2 and rec.n("stage.svd") == 0


def test_trace_writes_the_program_spans(tmp_path):
    pack = structured_pack(60, 50, seed=3)
    with pt.trace(str(tmp_path / "tr")):
        pt.snp_prodVec(pack, np.ones(50))
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    ev = doc["traceEvents"]
    mine = [e for e in ev if e.get("cat") == "program"]
    assert [e["name"] for e in mine] == ["prodvec", "host.read"]
    prod, read = mine
    assert prod["ts"] <= read["ts"] and (read["ts"] + read["dur"]
                                         <= prod["ts"] + prod["dur"])
    assert read["args"] == {"parent": 0, "call": 0}
    # on the trace's own time base: among the profiler's own events
    ops = [e for e in ev if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert min(e["ts"] for e in ops) - 1e3 <= prod["ts"]
    assert prod["ts"] <= max(e["ts"] + e["dur"] for e in ops) + 1e3
    assert take_profiled() is None
