"""The build loop's segments (``ops/snnls.py``: ``segments``, ``_segment``,
``build(segment=...)``) and the FISTA re-solve on device values alone, on
the CPU.

On a CUDA device ``build`` replays each segment as a CUDA graph; here the
same segment function runs directly.  Every length must give the weights,
atoms, ``itr`` and ``done`` of one-iteration segments bit for bit, also when
``done`` latches half-way through a segment (the iterations after it run
gated and change nothing).  GIGA and Frank-Wolfe through 64-iteration
segments are held to the JAX package's ``build`` with the tolerances of
``tests/test_torch_snnls.py`` (GIGA: rtol 1e-4, atol 1e-6) and
``tests/test_torch_solvers.py`` (Frank-Wolfe: rtol 1e-5, atol 1e-6).  A
segment and the re-solve run under a dispatch mode that raises on every op
that reads a value back to the host.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu_torch.ops import graphs
from bayesian_coresets_tpu_torch.ops import snnls as tsn

torch.set_num_threads(1)

GREEDY = ("giga", "frankwolfe", "orthopursuit")
SAMPLING = ("importance", "uniform")
# iterations before and in the build held to one-iteration segments: it
# starts mid-segment (50) and ends mid-segment; OMP (256 FISTA steps an
# iteration) takes fewer
SPAN = {"orthopursuit": (50, 30)}
SPAN_DEFAULT = (50, 100)
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique", "_unique2",
              "unique_dim", "unique_consecutive"}


def _problem(seed=0, S=64, n=300):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    A *= rng.uniform(0.2, 3.0, size=n).astype(np.float32)
    return A, A.sum(axis=1)


def _consts(method, sd=None, seed=0, S=64):
    A, b = _problem(seed, S=S)
    sampling = method if method in SAMPLING else None
    return tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b), select_dtype=sd,
                           sampling=sampling)


def _draws(method):
    return torch.Generator().manual_seed(11) if method in SAMPLING else None


def _equal(a, b):
    """Two states bit for bit, the weights compared as bits."""
    for name in tsn.SNNLSState._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


def _run(c, state, itrs, method, length, tol=1e-6):
    return tsn.build(c, state, itrs, tol, method=method, draws=_draws(method),
                     matvec_k=64, segment=length)


@pytest.mark.parametrize("length", [7, 64])
@pytest.mark.parametrize("method", GREEDY + SAMPLING)
def test_segments_equal_one_iteration_segments(method, length):
    """From iteration 50 on (mid-segment, after one refresh) to a mid-segment
    end: the segment lengths give one-iteration segments' state bit for bit."""
    sd = torch.int8 if method in GREEDY else None
    c = _consts(method, sd, S=128 if method == "orthopursuit" else 64)   # OMP: no latch
    head, span = SPAN.get(method, SPAN_DEFAULT)
    s0 = _run(c, tsn.init_state(c, 128), head, method, 1)
    ref = _run(c, s0, span, method, 1)
    out = _run(c, s0, span, method, length)
    assert int(ref.itr) == head + span and not bool(ref.done)
    _equal(out, ref)
    assert int(s0.itr) == head                   # the argument is left as it was


@pytest.mark.parametrize("method", ("giga", "frankwolfe"))
def test_segments_without_slots_equal_one_iteration_segments(method):
    """No support slots: the dense refresh and the any(w > 0) gates."""
    c = _consts(method)
    ref = _run(c, tsn.init_state(c), 140, method, 1)
    _equal(_run(c, tsn.init_state(c), 140, method, 64), ref)


@pytest.mark.parametrize("length", [7, 64])
@pytest.mark.parametrize("method", GREEDY + SAMPLING)
def test_overflow_latch_inside_a_segment(method, length):
    """max_active=3: the fourth distinct atom latches ``done`` inside the
    first segment; the gated iterations after it leave the state as the
    one-iteration run leaves it, and still run (``itrs_run``)."""
    c = _consts(method)
    tsn.itrs_run = 0
    ref = _run(c, tsn.init_state(c, 3), 100, method, 1)
    ran_ref = tsn.itrs_run
    tsn.itrs_run = 0
    out = _run(c, tsn.init_state(c, 3), 100, method, length)
    assert bool(ref.done) and int(ref.size) == 3 and int(ref.itr) < length
    assert ran_ref == int(ref.itr) and tsn.itrs_run == length
    _equal(out, ref)


@pytest.mark.parametrize("method", GREEDY)
def test_failure_latch_inside_a_segment(method):
    """A tolerance that no step after the first can meet (the error must
    halve): two failed steps in a row latch ``done`` inside a 64-segment."""
    c = _consts(method)
    ref = _run(c, tsn.init_state(c, 64), 100, method, 1, tol=-0.5)
    out = _run(c, tsn.init_state(c, 64), 100, method, 64, tol=-0.5)
    assert bool(ref.done) and int(ref.fail) == 2 and int(ref.itr) < 64
    _equal(out, ref)


def test_sampling_generator_runs_on_after_a_latch():
    """The gated draws after a latch advance the generator (the state does
    not move): build's docstring says so."""
    c = _consts("importance")
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    outs = [tsn.build(c, tsn.init_state(c, 3), 100, 1e-6, method="importance", draws=g,
                      segment=length) for g, length in zip(gens, (1, 64))]
    _equal(outs[1], outs[0])
    assert bool(outs[0].done)
    assert not torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("method,tol", [("giga", dict(rtol=1e-4, atol=1e-6)),
                                        ("frankwolfe", dict(rtol=1e-5, atol=1e-6))])
def test_64_segments_match_jax(method, tol):
    """The parity problem (S=256, n=512, f32), 200 iterations in 64-iteration
    segments against the JAX package's build: the same atoms in the same
    order, ``itr``, ``fail`` and ``done``, weights within the parity tests'
    tolerances."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(256, 512)).astype(np.float32)
    b = A.sum(axis=1)
    jc = jsn.make_consts(A, b)
    tc = tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b))
    js = jsn.build(jc, jsn.init_state(jc, max_active=256), 200, 1e-6, method=method)
    ts = tsn.build(tc, tsn.init_state(tc, 256), 200, 1e-6, method=method, segment=64)
    k = int(js.size)
    assert (int(ts.size), int(ts.itr), int(ts.fail), bool(ts.done)) == \
        (k, int(js.itr), int(js.fail), bool(js.done))
    np.testing.assert_array_equal(ts.idcs[:k].numpy(), np.asarray(js.idcs)[:k])
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), **tol)


class _NoHostRead(TorchDispatchMode):
    """Raises on every op that reads a tensor's value back to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("method", GREEDY + SAMPLING)
def test_a_segment_reads_nothing_back(method):
    """A 64-iteration segment that begins with the refresh, from a state
    with atoms, on device values alone."""
    c = _consts(method, torch.int8 if method in GREEDY else None,
                S=128 if method == "orthopursuit" else 64)
    s = _run(c, tsn.init_state(c, 128), 64, method, 1)
    nsum, cdf = tsn._derived(c, method)
    p = tsn._Problem(c, method, 1e-6, 64, None, tsn.as_draws(_draws(method)) if cdf is not None
                     else None, cdf, None, nsum)
    carry = tsn._carry(c, s, 64 + 64)
    with _NoHostRead():
        out = tsn._segment(p, carry, 64, True)
    assert int(out.itr) == 128
    with _NoHostRead(), pytest.raises(AssertionError, match="host read"):
        bool(out.done)


def test_optimize_active_reads_nothing_back():
    c = _consts("giga")
    s = _run(c, tsn.init_state(c, 64), 30, "giga", 1)
    idcs = torch.zeros(32, dtype=torch.int32)
    idcs[: int(s.size)] = s.idcs[: int(s.size)]
    size = int(s.size)
    with _NoHostRead():
        s2, ok = tsn.optimize_active(c, s, idcs, size, 1e-6)
    assert bool(ok) and float(tsn.error(c, s2.w)) <= float(tsn.error(c, s.w)) * (1 + 1e-6)


@pytest.mark.parametrize("start,count", [(0, 500), (50, 200), (50, 5), (64, 64), (127, 2),
                                         (0, 0), (3, 61)])
def test_plan_refreshes_at_multiples_of_64(start, count):
    plan = list(tsn.segments(start, count))
    pos = start
    for first, n, refresh in plan:
        assert first == pos and 1 <= n <= 64
        assert refresh == (first % 64 == 0)
        assert first // 64 == (first + n - 1) // 64        # no segment crosses a refresh
        pos += n
    assert pos == start + count
    # a head, whole segments and a tail: at most three (length, refresh) shapes
    assert len({(n, r) for _, n, r in plan}) <= 3
    assert all(n == 64 for _, n, _ in plan[1:-1])


def test_plan_of_shorter_segments():
    assert list(tsn.segments(50, 200)) == [(50, 14, False), (64, 64, True), (128, 64, True),
                                     (192, 58, True)]
    assert list(tsn.segments(50, 30, 8)) == [(50, 6, False), (56, 8, False), (64, 8, True),
                                       (72, 8, False)]
    assert [n for _, n, _ in tsn.segments(60, 10, 7)] == [3, 1, 6]
    with pytest.raises(ValueError, match="segment length"):
        list(tsn.segments(0, 10, 65))


def test_replayed_build_needs_a_generator():
    """A draw source that is not a generator cannot be replayed."""
    class Source:
        def index(self, cdf):
            return torch.zeros(1, dtype=torch.int64)

    with pytest.raises(ValueError, match="segment=1"):
        tsn._graph_generator(Source(), torch.device("cpu"))
    g = torch.Generator()
    assert tsn._graph_generator(g, torch.device("cpu")) is g
    assert tsn._graph_generator(tsn.Draws(g), torch.device("cpu")) is g
    fresh = tsn._graph_generator(None, torch.device("cpu"))
    assert torch.equal(fresh.get_state(), torch.Generator().get_state())


def test_copy_into_skips_buffers_updated_in_place():
    bufs = [torch.zeros(3), torch.zeros(2)]
    same = bufs[0].add_(1.0)
    graphs.copy_into(bufs, [same, torch.ones(2)])
    assert torch.equal(bufs[0], torch.ones(3)) and torch.equal(bufs[1], torch.ones(2))

