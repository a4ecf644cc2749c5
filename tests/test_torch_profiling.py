"""The port's span recorder (``utils/profiling.py``) on the CPU: a span with
both sinks off is the shared no-op and records nothing; on, records carry
their parent, the request's ``coreset`` serial and an exception that closed
them; a ``torch.profiler`` session sees spans as user annotations with the
program's tracing off; a Hilbert build, in memory and streamed, gives its
exact span tree (and through stand-in graphs, its captures and replays),
and the same weights and atoms bit for bit with tracing on.  The phase
timers' own tests are in ``test_torch_streamed.py``.  Card checks (events
never inside a capture, device intervals inside their host spans) are in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import bayesian_coresets_tpu_torch as bc
from bayesian_coresets_tpu_torch.models import logistic
from bayesian_coresets_tpu_torch.ops import graphs
from bayesian_coresets_tpu_torch.ops import snnls
from bayesian_coresets_tpu_torch.utils import profiling

N, D, S, M = 2000, 10, 50, 20


@pytest.fixture(autouse=True)
def clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _coreset(chunk=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    Z = torch.randn((N, D), generator=g)
    th = 0.1 * torch.randn((S, D), generator=g)
    proj = bc.BlackBoxProjector(lambda gen, n, w, p: th, S, logistic.log_likelihood,
                                generator=torch.Generator())
    if chunk is None:
        return bc.HilbertCoreset(Z, proj, select_dtype=torch.int8, max_active=64)
    return bc.HilbertCoreset(Z, proj, stream_chunk_size=chunk, max_active=64)


def _tree(recs):
    return [(r["name"], None if r["parent"] is None else recs[r["parent"]]["name"])
            for r in recs]


def test_off_a_span_is_the_shared_noop_and_records_nothing():
    a, b = profiling.span("hilbert.solve"), profiling.span("snnls.read", device=None, x=1)
    assert a is b
    with a:
        with b:
            torch.ones(3).sum()
    assert profiling.spans() == [] and profiling.report() == {} and profiling.dropped == 0


def test_on_records_parents_the_request_id_and_an_exception():
    profiling.enable()
    with profiling.span("hilbert.init", device=torch.device("cpu"), coreset=7, n=3):
        with profiling.span("hilbert.project"):
            pass
        with pytest.raises(ValueError):
            with profiling.span("hilbert.consts"):
                raise ValueError("boom")
    with profiling.span("hilbert.solve", coreset=8):
        with profiling.span("snnls.read"):
            pass
    profiling.disable()
    with profiling.span("after"):
        pass
    recs = profiling.spans()
    assert _tree(recs) == [("hilbert.init", None), ("hilbert.project", "hilbert.init"),
                           ("hilbert.consts", "hilbert.init"), ("hilbert.solve", None),
                           ("snnls.read", "hilbert.solve")]
    assert [r["coreset"] for r in recs] == [7, 7, 7, 8, 8]
    assert recs[0]["attrs"] == {"n": 3} and recs[1]["attrs"] == {}
    assert recs[2]["error"] == "ValueError" and recs[1]["error"] is None
    for r in recs:
        assert r["host_start"] <= r["host_end"]
        # CPU work: the device interval is the host interval
        assert (r["dev_start"], r["dev_end"]) == (r["host_start"], r["host_end"])
    assert recs[0]["host_start"] <= recs[1]["host_start"] <= recs[2]["host_end"] \
        <= recs[0]["host_end"] <= recs[3]["host_start"]


def test_records_past_the_limit_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)
    profiling.enable()
    with profiling.span("a", coreset=1):
        for _ in range(4):
            with profiling.span("b"):
                pass
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["a", "b", "b"] and profiling.dropped == 2
    assert profiling.report()["b"]["count"] == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped == 0


def test_a_torch_profiler_session_sees_spans_with_tracing_off():
    from torch.profiler import ProfilerActivity, profile

    assert profiling.span("x") is profiling.span("y")     # off
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("hilbert.solve", coreset=1):
            with profiling.span("snnls.read"):
                torch.ones(4).sum()
    names = {e.name: e for e in prof.events()}
    assert {"hilbert.solve", "snnls.read"} <= set(names)
    assert names["snnls.read"].is_user_annotation
    assert profiling.spans() == []
    with profiling.span("after") as nothing:     # the session ended: the no-op again
        assert nothing is None
    assert profiling.span("x") is profiling.span("y")


def test_phase_records_with_tracing_off_and_nests_under_spans():
    with profiling.phase("construct", sync=torch.ones(2)):
        with profiling.span("hilbert.project"):   # off: not recorded
            pass
    profiling.enable()
    with profiling.span("hilbert.solve", coreset=4):
        with profiling.phase("build"):
            pass
    recs = profiling.spans()
    assert _tree(recs) == [("construct", None), ("hilbert.solve", None),
                           ("build", "hilbert.solve")]
    assert recs[2]["coreset"] == 4
    rep = profiling.report()
    assert rep["build"]["count"] == 1 and rep["build"]["device_s"] >= 0.0
    assert rep["construct"]["mean_s"] == rep["construct"]["total_s"]


def _expected(reads):
    return ([("hilbert.init", None), ("hilbert.project", "hilbert.init"),
             ("hilbert.consts", "hilbert.init"), ("hilbert.solve", None)]
            + [("snnls.read", "hilbert.solve")] * reads + [("hilbert.active", "hilbert.solve")])


@pytest.mark.parametrize("chunk", [None, 500], ids=["in_memory", "streamed"])
def test_a_build_gives_its_span_tree(chunk):
    profiling.enable()
    itrs0 = snnls.itrs_run
    c = _coreset(chunk)
    c.build(M)
    c.get()
    segments = snnls.itrs_run - itrs0          # one-iteration segments on the CPU
    recs = profiling.spans()
    assert segments == M and _tree(recs) == _expected(segments)
    assert {r["coreset"] for r in recs} == {c.serial}
    init, project, consts = recs[:3]
    for inner in (project, consts):
        assert init["host_start"] <= inner["host_start"] <= inner["host_end"] <= init["host_end"]
    assert _coreset(chunk).serial > c.serial


@pytest.mark.parametrize("chunk", [None, 500], ids=["in_memory", "streamed"])
def test_a_traced_build_is_bit_identical(chunk):
    off = _coreset(chunk)
    off.build(M)
    profiling.enable()
    on = _coreset(chunk)
    on.build(M)
    assert len(profiling.spans()) > M
    (w0, p0, i0), (w1, p1, i1) = off.get(), on.get()
    assert np.array_equal(i0, i1) and np.array_equal(p0, p1)
    assert w0.dtype == w1.dtype and np.array_equal(w0.view(np.uint8), w1.view(np.uint8))
    assert off.error() == on.error()


class _FirstWork:
    """Stands in for ``ops.graphs.Graph`` on the CPU: every replay runs the
    work it was made with."""

    def __init__(self, fn, stream, pool, generators=()):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def cpu_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", _FirstWork)
    monkeypatch.setattr(graphs, "side_stream", lambda dev: None)
    monkeypatch.setattr(graphs, "_stream", lambda dev: (-1, 0))
    monkeypatch.setattr(graphs, "_memory", lambda dev: 1 << 30)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(snnls, "_replaying", lambda dev, comm, segment: segment != 1)
    graphs.release()
    yield
    graphs.release()


def test_replayed_pieces_and_their_captures_nest_in_the_solve(cpu_graphs):
    """A build replayed through stand-in graphs: each piece in a
    ``graphs.replay`` span labelled with its set's kind and its key, a
    capture before its first replay, none on new constants of the layout,
    and the same answer as a traced-off build."""
    profiling.enable()
    first = _coreset(seed=0)
    first.build(100)
    recs = profiling.spans()
    solve = next(i for i, r in enumerate(recs) if r["name"] == "hilbert.solve")
    inner = [(r["name"], r["attrs"]) for r in recs[solve + 1:] if r["parent"] == solve]
    # segments of 64 from 0, each beginning with the refresh: 64, then 36 = 32 + 4
    pieces = [(64, True), (32, True), (4, False)]
    expect = [("graphs.capture", {"kind": "build"}),
              ("graphs.replay", {"kind": "build", "key": pieces[0]}),
              ("snnls.read", {})]
    for p in pieces[1:]:
        expect += [("graphs.capture", {"kind": "build"}),
                   ("graphs.replay", {"kind": "build", "key": p})]
    assert inner == expect + [("snnls.read", {}), ("hilbert.active", {})]
    profiling.reset()
    second = _coreset(seed=1)
    second.build(100)
    names = [r["name"] for r in profiling.spans()]
    assert names.count("graphs.replay") == 3 and "graphs.capture" not in names
    profiling.disable()
    off = _coreset(seed=1)
    off.build(100)
    (w0, _, i0), (w1, _, i1) = off.get(), second.get()
    assert np.array_equal(i0, i1) and np.array_equal(w0.view(np.uint8), w1.view(np.uint8))
