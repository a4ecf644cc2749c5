"""The metrics that read the program's own spans: a toy traced run of each
cell on the CPU reports those of the cell's span metrics that read without
a card (the construction's two spans) and leaves out those that need
replayed graphs; a program without the span recorder gives none of them and
raises nothing.  :func:`spans_read` takes any cell cut to a toy size
(``test_bench_room.py`` runs it on a cell of another model)."""

import time

import pytest

from benchmark import harness, program_spans

from .toy import toy_cell

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 54321
SPAN_METRICS = [m["name"] for m in SPEC["per_layer"] if m["source"] == "program_span"]


def spans_read(c, cpu):
    """A traced toy run of the cell ``c``: each of its metrics that read the
    program's spans reads a finite positive value, or, where its reader
    needs a card, nothing; its other metrics that read without a card,
    read before the spans' jobs run, still report."""
    res, _ = harness.run(c, SEED, 0.5, True, cpu, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    for name in (m["name"] for m in c.per_layer if m["source"] == "program_span"):
        if harness.card_only(name):
            assert name not in res["metrics"], name
        else:
            assert 0 < res["metrics"][name]["value"] < float("inf"), name
    assert {m["name"] for m in c.per_layer if m["source"] != "program_span"
            and not harness.card_only(m["name"])} <= set(res["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_construction_spans(cell, cpu):
    spans_read(toy_cell(cell), cpu)


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
    assert SPAN_METRICS
    for name in SPAN_METRICS:
        assert harness.reader(name)(ctx) is None
    assert job.answers == {}


def _cells(metric: dict) -> set:
    return set(metric.get("workloads", CELLS))


def test_capture_ms_is_read_only_where_each_build_captures():
    m = {x["name"]: x for x in SPEC["per_layer"]}
    assert m["hilbert.capture_ms"]["workloads"] == ["lr8m.giga_int8"]
    assert set(SPAN_METRICS) >= {"hilbert.project_ms", "hilbert.consts_ms",
                                 "hilbert.replay_itr_ms", "hilbert.off_graph_pct",
                                 "hilbert.capture_ms"}
    for name in SPAN_METRICS:
        assert m[name]["moves"] == "hilbert_points_per_s"
    # in each cell, the readers that run the spans' jobs come after the others
    order = SPEC["per_layer"]
    for i, a in enumerate(order):
        for b in order[i + 1:]:
            if a["source"] == "program_span" and b["source"] != "program_span":
                assert not _cells(a) & _cells(b), (a["name"], b["name"])
