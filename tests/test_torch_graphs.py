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

A build's graph set is keyed by the shape of the problem (``ops/graphs.py``:
``layout``, ``set_key``), as the JAX package compiles ``build`` once per
shape, and its graphs read static copies of the constants (``Statics``).
The key, the copies and their lifetime are held here; a stand-in for a
captured graph, which replays the work it first saw, holds interleaved
constants of one shape to their own direct builds bit for bit.

A replayed segment runs as pieces whose lengths are powers of two
(``snnls.pieces``), so a set holds at most 14 graphs (OMP 6) whatever the
builds' lengths and starts: the plan is held for the increments of the
drivers' log grid, and builds walked over that grid through the stand-in
equal their one-iteration builds.  A shared set draws from a generator of
its own, loaded with the caller's state (``graphs.draw_from``): generators
alternating through one set each give their direct build's draws and end
where it leaves them.  The static copies of a layout whose last constants
died are retired, revived by new constants of the layout without a
capture, evicted least recently used past a budget, and dropped by
``graphs.release()``.
"""

import gc

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu_torch.experiments.cli import coreset_size_grid
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


def _consts(method, sd=None, seed=0, S=64, n=300):
    A, b = _problem(seed, S=S, n=n)
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



# ------------------------------------------------ one graph set per shape


def _key(c, method="giga", tol=1e-6, stream=(0, 1)):
    """The key of the graph set that a replayed build of ``c`` runs in."""
    carry = tsn._carry(c, tsn.init_state(c, 64), 10)
    return graphs.set_key(tuple(c), tsn._build_key(method, tol, 64, carry), stream,
                          tsn._shares_graphs(c))


@pytest.mark.parametrize("sd", [None, torch.bfloat16, torch.int8])
def test_one_key_for_constants_of_one_layout(sd):
    """Two constants of one shape, dtype, strides and aliasing, from other
    data: one shared set."""
    a, b = _consts("giga", sd, seed=0), _consts("giga", sd, seed=1)
    assert not torch.equal(a.V, b.V)
    assert (a.Vsel is a.V) == (sd is None) == (b.Vsel is b.V)
    assert _key(a) == _key(b) and _key(a)[0] is True


def _other(name, c):
    """(constants, method, tol) that differ from (``c``, giga, 1e-6) in one
    thing only."""
    if name == "dtype":                  # int8 and bf16 select copies of one shape
        return _consts("giga", torch.bfloat16), "giga", 1e-6
    if name == "shape":
        return _consts("giga", torch.int8, n=301), "giga", 1e-6
    if name == "aliasing":               # f32: Vsel is V, against a copy of V
        return c._replace(Vsel=c.V.clone()), "giga", 1e-6
    if name == "method":
        return c, "frankwolfe", 1e-6
    return c, "giga", 1e-5


@pytest.mark.parametrize("name", ["dtype", "shape", "aliasing", "method", "tol", "stream"])
def test_keys_differ_in_layout_method_tol_and_stream(name):
    c = _consts("giga", None if name == "aliasing" else torch.int8)
    if name == "stream":
        assert _key(c) != _key(c, stream=(0, 2))
        return
    other, method, tol = _other(name, c)
    assert _key(c) != _key(other, method, tol)


def test_int8_resident_constants_keep_sets_of_their_own():
    """int8-resident constants are not copied: their key says so (as for
    constants with a tensor that is not contiguous)."""
    from bayesian_coresets_tpu_torch.parallel import quantize_chunk
    A, _ = _problem()
    q, nrm, bsum = quantize_chunk(torch.as_tensor(A).T.contiguous(), A.shape[1])
    cq = tsn.make_consts_quantized(q, nrm, bsum.float())
    assert cq.Vsel is cq.V and not tsn._shares_graphs(cq) and _key(cq)[0] is False
    c = _consts("giga", torch.int8)
    assert tsn._shares_graphs(c)
    strided = c._replace(b=torch.stack([c.b, c.b], dim=1)[:, 0])
    assert torch.equal(strided.b, c.b) and not tsn._shares_graphs(strided)


def _same_values(xs, ys):
    return all(torch.equal(x, y) for x, y in zip(xs, ys, strict=True))


def test_statics_copy_in_only_other_constants():
    """Static copies keep ``Vsel is V`` as one buffer, take each constants'
    values, copy nothing for the constants copied in last, copy again after
    another constants or a write, and never write the caller's tensors."""
    a, b = _consts("giga", seed=0), _consts("giga", seed=1)
    a0, b0 = [t.clone() for t in a], [t.clone() for t in b]
    st = graphs.Statics(tuple(a), "k")
    assert st.tensors[6] is st.tensors[0] and len({id(t) for t in st.tensors}) == 6
    assert st.load(tuple(a)) and not st.load(tuple(a)) and _same_values(st.tensors, a)
    assert st.load(tuple(b)) and not st.load(tuple(b)) and _same_values(st.tensors, b)
    assert st.load(tuple(a)) and _same_values(st.tensors, a) and st.loads == 3
    a.b.mul_(2.0)                        # written since it was copied in
    assert st.load(tuple(a)) and torch.equal(st.tensors[1], a.b)
    a.b.div_(2.0)
    assert _same_values(a, a0) and _same_values(b, b0)


def test_statics_go_with_their_last_user(cpu_graphs):
    """The last user's death retires the static copies (kept, their bytes
    counted in ``retained_bytes``); ``release()`` drops them."""
    a, b = _consts("giga", seed=0), _consts("giga", seed=1)
    key = ("test", graphs.layout(tuple(a)))
    st = graphs._statics_for(tuple(a), key)
    assert graphs._statics_for(tuple(b), key) is st and len(st.users) == 2
    del a
    gc.collect()
    assert graphs._statics.get(key) is st and len(st.users) == 1
    assert key not in graphs._retired and graphs.retained_bytes == 0
    del b
    assert graphs._statics.get(key) is st and not st.users and key in graphs._retired
    assert graphs.retained_bytes == st.nbytes() == sum(
        st.tensors[i].numel() * st.tensors[i].element_size() for i in st.distinct) > 0
    graphs.release()
    assert key not in graphs._statics and not graphs._retired and graphs.retained_bytes == 0


class _FirstWork:
    """Stands in for ``ops.graphs.Graph`` on the CPU: it runs, at every
    replay, the work it was made with, as a CUDA graph replays the kernels,
    and the tensors, that it captured; ``made`` counts the captures."""

    made = 0

    def __init__(self, fn, stream, pool, generators=()):
        type(self).made += 1
        self.fn = fn

    def replay(self):
        self.fn()


MEMORY = 1 << 30       # the stand-in device's memory, which the retention budget shares


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Graph sets on the CPU with :class:`_FirstWork` for their graphs, and
    ``build`` replaying through them; no retired entry before or after."""
    monkeypatch.setattr(graphs, "Graph", _FirstWork)
    monkeypatch.setattr(graphs, "side_stream", lambda dev: None)
    monkeypatch.setattr(graphs, "_stream", lambda dev: (-1, 0))
    monkeypatch.setattr(graphs, "_memory", lambda dev: MEMORY)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(tsn, "_replaying", lambda dev, comm, segment: segment != 1)
    _FirstWork.made = 0
    graphs.release()
    yield
    graphs.release()


def _replayed(c, itrs, method, gen=None):
    """A build's replay loop (``build`` replays on a CUDA device only), the
    carry copied out; a sampling build draws from ``gen``, seeded as
    :func:`_draws` seeds its generator."""
    s = tsn.init_state(c, 128)
    carry = tsn._carry(c, s, itrs)
    step, st, drawing = tsn._replayer(c, carry, method, 1e-6, gen and gen.manual_seed(11), 64)
    with drawing:
        for _, n, refresh in tsn.segments(0, itrs):
            st = step(st, n, refresh)
    return tsn._Carry(*(t.clone() for t in st))


def _direct(c, itrs, method):
    s = tsn.init_state(c, 128)
    nsum, cdf = tsn._derived(c, method)
    draws = tsn.as_draws(_draws(method)) if cdf is not None else None
    p = tsn._Problem(c, method, 1e-6, 64, None, draws, cdf, None, nsum)
    carry = tsn._carry(c, s, itrs)._replace(w=s.w.clone(), cts=s.cts.clone())
    for _, n, refresh in tsn.segments(0, itrs):
        carry = tsn._segment(p, carry, n, refresh)
    return carry


def _same_carry(a, b):
    for name, x, y in zip(tsn._Carry._fields, a, b, strict=True):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("method,kind", [("giga", "int8"), ("giga", "float32"),
                                         ("frankwolfe", "int8"), ("orthopursuit", "int8"),
                                         ("importance", "float32"), ("uniform", "float32")])
def test_interleaved_constants_of_one_shape_read_their_own(method, kind, cpu_graphs):
    """Constants A, B, A of one shape through one graph set whose stand-in
    graphs replay the work of A's build: each build equals its own direct
    build bit for bit (every tensor the work reads, derived ones included,
    is a static copy), and only A's first build captures (the sampling
    builds draw from one generator, reseeded)."""
    S = 128 if method == "orthopursuit" else 64
    itrs = 20 if method == "orthopursuit" else 150
    sd = torch.int8 if kind == "int8" else None         # float32: Vsel is V
    a, b = (_consts(method, sd, seed=k, S=S) for k in (0, 1))
    refs = {k: _direct(c, itrs, method) for k, c in (("a", a), ("b", b))}
    gen, made = _draws(method), []
    for k, c in (("a", a), ("b", b), ("a", a)):
        _same_carry(_replayed(c, itrs, method, gen), refs[k])
        made.append(_FirstWork.made)
    assert made[0] > 0 and made[1] == made[2] == made[0]
    assert not torch.equal(refs["a"].xw, refs["b"].xw)


def test_int8_resident_constants_capture_their_own(cpu_graphs):
    """Two int8-resident constants of one shape: the second captures sets of
    its own, and each equals its direct build."""
    from bayesian_coresets_tpu_torch.parallel import quantize_chunk
    made = []
    for seed in (0, 1):
        A, _ = _problem(seed)
        q, nrm, bsum = quantize_chunk(torch.as_tensor(A).T.contiguous(), A.shape[1])
        c = tsn.make_consts_quantized(q, nrm, bsum.float())
        _same_carry(_replayed(c, 100, "giga"), _direct(c, 100, "giga"))
        made.append(_FirstWork.made)
    assert 0 < made[0] < made[1]


# ------------------------------ pieces, generators and retired sets


def _increments(size_max, num_sizes):
    """(start, count) of each build of a driver's walk over its log grid of
    sizes (``experiments/cli.py``: the first build takes the first size)."""
    Ms = coreset_size_grid(size_max, num_sizes, "log").tolist()
    return list(zip([0] + Ms[:-1], [Ms[0]] + [b - a for a, b in zip(Ms, Ms[1:])]))


PLAN_CASES = _increments(500, 7) + [(37, 27), (448, 52), (0, 1), (60, 10), (1, 498)]


@pytest.mark.parametrize("length", [64, 4])
@pytest.mark.parametrize("start,count", PLAN_CASES)
def test_pieces_compose_each_segment(start, count, length):
    """Each segment of a build is cut into pieces of power-of-two lengths,
    largest first, that compose it exactly; only a piece at a multiple of
    64 refreshes, and it is the segment's first."""
    pos = start
    for first, n, refresh in tsn.segments(start, count, length):
        for m, r in tsn.pieces(n, refresh):
            assert m & (m - 1) == 0 and 1 <= m <= length
            assert r == (pos == first and pos % 64 == 0)
            pos += m
        assert pos == first + n
        assert [m for m, _ in tsn.pieces(n, refresh)] == sorted(
            (m for m, _ in tsn.pieces(n, refresh)), reverse=True)
    assert pos == start + count


def test_pieces_of_a_head_and_a_tail():
    assert tsn.pieces(27, False) == [(16, False), (8, False), (2, False), (1, False)]
    assert tsn.pieces(52, True) == [(32, True), (16, False), (4, False)]
    assert tsn.pieces(64, True) == [(64, True)] and tsn.pieces(0, True) == []


@pytest.mark.parametrize("length,most", [(64, 14), (4, 6)])
@pytest.mark.parametrize("grid", [(500, 7), (1000, 50), (60, 7)])
def test_a_set_holds_a_bounded_number_of_keys(grid, length, most):
    """Every walk over a log grid, and every build of any length from any
    start up to 600, needs at most 14 graph keys (OMP's 4-iteration
    segments 6)."""
    walks = [_increments(*grid), [(s, c) for s in range(0, 130) for c in range(0, 70, 3)]]
    for walk in walks:
        keys = {p for start, count in walk for _, n, r in tsn.segments(start, count, length)
                for p in tsn.pieces(n, r)}
        assert len(keys) <= most


def _walk(c, method, increments, segment=None, gen=None, max_active=512):
    """``build`` over ``increments`` (the iterations of each call), from a
    fresh state; a sampling build draws from ``gen``."""
    s = tsn.init_state(c, max_active)
    for k in increments:
        s = tsn.build(c, s, k, 1e-6, method=method, draws=gen, matvec_k=64, segment=segment)
    return s


def _keys():
    """The graph keys of every live or retired shared set."""
    return [len(e.graphs) for st in graphs._statics.values() for e in st.sets.values()]


@pytest.mark.parametrize("method,kind", [("giga", "int8"), ("giga", "float32"),
                                         ("frankwolfe", "int8"), ("orthopursuit", "int8"),
                                         ("importance", "float32"), ("uniform", "float32")])
def test_log_grid_walks_equal_one_iteration_builds(method, kind, cpu_graphs):
    """``build`` walked over the log grid of sizes up to 500 (OMP: 60)
    through the stand-in graphs, on constants A and then on constants B of
    A's layout: each walk equals its one-iteration walk bit for bit (the
    sampling walks' generators end alike), A's walk captures at most 14
    graphs (OMP 6) and B's none."""
    omp = method == "orthopursuit"
    incs = [k for _, k in _increments(60 if omp else 500, 7)]
    sd = torch.int8 if kind == "int8" else None
    made = []
    for seed in (0, 1):
        c = _consts(method, sd, seed=seed, S=128, n=600)
        gens = [torch.Generator().manual_seed(7 + seed) if method in SAMPLING else None
                for _ in range(2)]
        before = _FirstWork.made
        out = _walk(c, method, incs, gen=gens[0])
        made.append(_FirstWork.made - before)
        _equal(out, _walk(c, method, incs, segment=1, gen=gens[1]))
        if gens[0] is not None:
            assert torch.equal(gens[0].get_state(), gens[1].get_state())
        assert int(out.itr) == sum(incs) and not bool(out.done)
        assert max(_keys()) <= (6 if omp else 14)
    assert 0 < made[0] <= (6 if omp else 14) and made[1] == 0


@pytest.mark.parametrize("method", SAMPLING)
def test_generators_alternate_through_one_set(method, cpu_graphs):
    """Generators A, B, A through one sampling set: each build draws what
    its direct build draws (weights and counts bit for bit), each generator
    ends where the direct build leaves it, and only the first build
    captures."""
    c = _consts(method)
    gens = {k: torch.Generator().manual_seed(seed) for k, seed in (("a", 5), ("b", 6))}
    refs = {k: torch.Generator().manual_seed(seed) for k, seed in (("a", 5), ("b", 6))}
    made = []
    for k in ("a", "b", "a"):
        before = _FirstWork.made
        out = tsn.build(c, tsn.init_state(c, 128), 90, 1e-6, method=method, draws=gens[k])
        made.append(_FirstWork.made - before)
        ref = tsn.build(c, tsn.init_state(c, 128), 90, 1e-6, method=method, draws=refs[k],
                        segment=1)
        _equal(out, ref)
        assert torch.equal(gens[k].get_state(), refs[k].get_state())
    assert made[0] > 0 and made[1:] == [0, 0]
    e = next(iter(graphs.statics_of(tuple(c)).sets.values()))
    assert e.gen is not gens["a"] and e.gen is not gens["b"]


def test_a_generator_that_cannot_be_loaded_raises(cpu_graphs):
    """A set's own generator takes the caller's state or the build raises:
    a state of another size is refused, and no set is made again."""
    c = _consts("uniform")
    tsn.build(c, tsn.init_state(c, 16), 10, 1e-6, method="uniform",
              draws=torch.Generator().manual_seed(1))
    e = next(iter(graphs.statics_of(tuple(c)).sets.values()))

    class Odd(torch.Generator):
        def get_state(self):
            return torch.zeros(3, dtype=torch.uint8)

    with pytest.raises(RuntimeError):
        with graphs.draw_from(e, Odd()):
            pass
    made = _FirstWork.made
    tsn.build(c, tsn.init_state(c, 16), 10, 1e-6, method="uniform",
              draws=torch.Generator().manual_seed(2))
    assert next(iter(graphs.statics_of(tuple(c)).sets.values())) is e
    assert _FirstWork.made == made


@pytest.mark.parametrize("method", ["giga", "uniform"])
def test_retired_statics_are_revived_without_a_capture(method, cpu_graphs):
    """A layout whose last constants died keeps its static copies and sets
    (retired); new constants of the layout revive them: they are copied in,
    nothing is captured, and the build equals its direct build."""
    a = _consts(method, seed=0)
    _replayed(a, 150, method, _draws(method))
    st = graphs.statics_of(tuple(a))
    del a
    gc.collect()
    assert st.key in graphs._retired and graphs._retired[st.key][1] == st.nbytes() > 0
    b = _consts(method, seed=1)
    revivals, loads, made = graphs.revivals, st.loads, _FirstWork.made
    _same_carry(_replayed(b, 150, method, _draws(method)), _direct(b, 150, method))
    assert graphs.statics_of(tuple(b)) is st and graphs.revivals == revivals + 1
    assert st.loads == loads + 1 and _FirstWork.made == made
    assert st.key not in graphs._retired and len(st.users) == 1


def test_retired_statics_are_evicted_least_recently_used(cpu_graphs, monkeypatch):
    """Retired entries stay while they fit in the budget; past it the least
    recently retired go first, at the next set made; ``release()`` drops
    the rest."""
    def retire(n):
        c = _consts("giga", n=n)
        graphs._statics_for(tuple(c), ("test", n))
        return c

    def size(n):
        return graphs._statics[("test", n)].nbytes()

    for n in (300, 301):
        retire(n)
    gc.collect()
    assert list(graphs._retired) == [("test", 300), ("test", 301)]
    c = retire(300)                     # revived, used and retired again: the newest
    assert list(graphs._retired) == [("test", 301)]
    del c
    gc.collect()
    assert list(graphs._retired) == [("test", 301), ("test", 300)]
    assert graphs.retained_bytes == size(300) + size(301)
    monkeypatch.setattr(graphs, "RETAINED_SHARE", (size(300) + size(301) - 1) / MEMORY)
    keep = retire(302)                  # evicts 301, the oldest, and keeps 300
    assert ("test", 301) not in graphs._statics and list(graphs._retired) == [("test", 300)]
    assert graphs.retained_bytes == size(300)
    del keep
    gc.collect()
    assert list(graphs._retired) == [("test", 300), ("test", 302)]
    assert graphs.retained_bytes == size(300) + size(302)
    monkeypatch.setattr(graphs, "RETAINED_SHARE", 0.0)
    graphs.graphs_for(tuple(_consts("giga")), ("other",), None, lambda: (torch.zeros(1),))
    assert not graphs._retired and graphs.retained_bytes == 0
    retire(301)
    gc.collect()
    assert list(graphs._retired) == [("test", 301)]
    graphs.release()
    assert ("test", 301) not in graphs._statics and graphs.retained_bytes == 0


def test_captures_are_counted_by_kind(cpu_graphs):
    """A build's graphs count under ``build``, their seconds beside them."""
    graphs.captures_by_kind.clear()
    graphs.capture_s_by_kind.clear()
    _replayed(_consts("giga"), 100, "giga")
    assert graphs.captures_by_kind == {"build": _FirstWork.made} and _FirstWork.made > 0
    assert list(graphs.capture_s_by_kind) == ["build"]
