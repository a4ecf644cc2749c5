"""The metrics that read the program's own spans: a toy traced run of each
cell on the CPU reports the construction's two spans and leaves out those
that need replayed graphs; a program without the span recorder gives none
of them and raises nothing."""

import time

import pytest

from benchmark import harness, program_spans

from .toy import toy_cell

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2**31 + 54321
READ = ("hilbert.project_ms", "hilbert.consts_ms")
NEED_GRAPHS = ("hilbert.replay_itr_ms", "hilbert.off_graph_pct", "hilbert.capture_ms")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_construction_spans(cell, cpu):
    c = toy_cell(cell)
    res, _ = harness.run(c, SEED, 0.5, True, cpu, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    for name in READ:
        v = res["metrics"][name]["value"]
        assert 0 < v < float("inf"), name
    assert not set(NEED_GRAPHS) & set(res["metrics"])
    # the four metrics read before the spans' jobs still report
    assert {"hilbert.construct_ms", "hilbert.itr_ms", "hilbert.step_mfu"} <= set(res["metrics"])


def test_the_spans_jobs_lie_past_the_window_and_the_trace(cpu):
    from bayesian_coresets_tpu_torch.utils import profiling

    c = toy_cell(CELLS[0])
    job = harness.job_module(c.traffic).Job(c.config, c.traffic, c.check, SEED, cpu)
    job.warm()
    win = harness.run_window(job, 0.2, False, cpu)
    ctx = harness.Context(c, job, win, 0.0)
    got = program_spans.collect(ctx)
    n = c.check["trace_jobs"]
    assert got["jobs"] == n and len(got["job_s"]) == n and got["itrs"] > 0
    assert sorted(job.answers)[-n:] == list(range(win.attempted + n, win.attempted + 2 * n))
    assert len(program_spans.named(got["spans"], "hilbert.init")) == n
    assert len(program_spans.under(got["spans"], "snnls.read", "hilbert.solve")) > 0
    assert program_spans.collect(ctx) is got              # once a run
    assert profiling.span("x") is profiling.span("y") and profiling.spans() == []


def test_a_program_without_the_span_recorder_reads_nothing(cpu, monkeypatch):
    from bayesian_coresets_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "enable")
    c = toy_cell(CELLS[0])
    job = harness.job_module(c.traffic).Job(c.config, c.traffic, c.check, SEED, cpu)
    ctx = harness.Context(c, job, harness.stats.Window(), 0.0)
    for name in READ + NEED_GRAPHS:
        assert harness.reader(name)(ctx) is None
    assert job.answers == {}


def test_capture_ms_is_read_only_where_each_build_captures():
    spec = harness.load_spec()
    m = {x["name"]: x for x in spec["per_layer"]}
    assert m["hilbert.capture_ms"]["workloads"] == ["lr8m.giga_int8"]
    for name in READ + NEED_GRAPHS:
        assert m[name]["source"] == "program_span"
        assert m[name]["moves"] == "hilbert_points_per_s"
    assert [x["name"] for x in spec["per_layer"]][-5:] == list(READ + NEED_GRAPHS)
