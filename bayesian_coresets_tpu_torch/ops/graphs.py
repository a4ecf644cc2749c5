"""Capture and replay of CUDA graphs: the build loop, the FISTA solve,
NUTS's tree and projected Adam's steps as device programs.

The JAX package runs a whole Hilbert build as one device program
(``bayesian_coresets_tpu/ops/snnls.py::build_core``, a ``lax.while_loop``),
the FISTA re-solve as a ``fori_loop`` inside a jitted function, and a NUTS
run as one jitted program of scans over nested while loops
(``bayesian_coresets_tpu/mcmc/sample.py``, ``mcmc/nuts.py``), so the host
launches nothing per iteration or leaf.  On a CUDA device the port gets the
same from captured CUDA graphs: :mod:`.snnls` captures a segment of build
iterations, or one solve, once and replays it, and the host reads back one
pair of values per segment instead of one or more per iteration;
:mod:`..mcmc.nuts` replays a transition's pieces (its start, a doubling's
start, a segment of leaves, a doubling's merge) and reads one flag per
segment; :mod:`.opt` replays segments of Adam steps (the JAX package's
``lax.scan`` in ``nn_opt``) and reads nothing.

- **One :class:`Graphs` per static state.**  It holds static buffers that
  carry the state through its replays (copied in before them and out
  after; nested tuples of tensors), the graphs themselves, keyed by the
  caller (a segment's length and whether it begins with the refresh; a
  solve's padded size; a NUTS piece), and one memory pool that they share:
  they run one after the other on one stream, and each copies what it
  keeps into the static buffers, so one graph's scratch may be another's.
  A NUTS run holds its own for the run's length, made on its first
  transition's carry.
- **One set per shape** (the JAX package's ``jax.jit`` of ``build``,
  ``bayesian_coresets_tpu/ops/snnls.py:992``, compiled once per shape).
  :func:`graphs_for` keys a build's or a re-solve's set by :func:`set_key`:
  the caller's key (the method, ``tol``, ``matvec_k``, the carry's dtypes
  and shapes), the caller stream, and the constants' :func:`layout` (each
  tensor's dtype, shape and strides, and which of them are one tensor:
  ``Vsel`` *is* ``V`` for f32 without a column pad).  Every constants of
  that layout share the set's graphs, which read static copies of the
  constants (:class:`Statics`, one buffer per distinct tensor, shared by
  the sets of every key on that layout and stream).  Before a replay the
  caller's constants are copied into them on the caller stream, unless
  they are the ones copied in last (the same tensor objects, not written
  since), and what the work derives from the constants alone (Frank-Wolfe's
  norm sum, the sampling solvers' cdf) is made again into its static
  buffers.  The constants passed in are only read.  A shared set's graphs
  draw from a generator of the set's own: the caller loads its
  generator's state into it before the replays and takes it back after
  (the JAX package passes the key as an argument), so one set serves
  every generator.
- **Retired, not dropped.**  When the last constants that used the static
  copies die (weak references to each user's ``V``), the copies and their
  sets are retired: kept while the retired copies and their sets' static
  buffers (``retained_bytes``) fit in :data:`RETAINED_SHARE` of the
  device's memory.  New constants of the layout revive them
  (``revivals``: one copy-in, no capture).  Past the budget the least
  recently retired are dropped first, at the next :func:`graphs_for`,
  never in the weak reference's callback, which may run inside a capture;
  :func:`release` drops them all.
- **Sets of their own.**  int8-resident constants (``V`` the int8 select
  copy, up to 4.1 GB at N=8M) are not copied: their sets read the
  constants themselves, hang off their ``V`` (a weak key) and are made
  again when any other tensor of the constants, or the generator, is not
  the one they were captured with.  ``nn_opt``'s sets hang off the data
  alike.
- **Capture stream.**  Each caller stream has a side stream of its own,
  made and warmed once before its first capture: the select kernels'
  workspace for that stream (:func:`.giga_select.workspace`) and its
  cuBLAS handle are made there outside any capture.  Captures use
  ``capture_error_mode="global"``, so a host read or a synchronizing call
  inside one raises.  Replays run on the caller's current stream.
  ``capture_s`` and ``instantiate_s`` time the two halves of a capture;
  ``captures_by_kind`` and ``capture_s_by_kind`` split the captures by
  the kind of their set (``build``, ``optimize``, ``nn_opt``, ``nuts``).
- **Generators.**  A generator that the captured work draws from is
  registered with the graph (``CUDAGraph.register_generator_state``; the
  default generator registers itself), so every replay draws what the same
  calls would draw eagerly and advances the generator by the whole graph's
  draws.
- **Warm-up.**  A :class:`Graphs` made with ``warm=True`` runs each key's
  work once directly on the capture stream before it captures it (the
  next time): lazy state that autograd or a library makes at first use is
  made outside any capture.  The direct run is the same work on the same
  buffers, so it gives what a replay gives.
- **Launch counts.**  The kernels' counters (:mod:`.giga_select`'s,
  :mod:`.fold_scale`'s and :mod:`.giga_step`'s) count wrapper calls, and a
  replay makes none: each graph keeps the launches that its capture
  recorded (and takes them back off the counters: a capture launches
  nothing) and adds them at every replay.
- **No fallback.**  A capture or replay that fails raises.
"""

from __future__ import annotations

import contextlib
import functools
import time
import weakref
from collections import OrderedDict

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.profiling import span
from . import fold_scale as fs
from . import giga_select as gs
from . import giga_step as gst

captures = 0        # graphs captured (since last set to 0)
capture_s = 0.0     # seconds spent capturing them (recording the work)
instantiate_s = 0.0     # seconds spent instantiating them
replays = 0         # graph replays
loads = 0           # constants copied into static copies (Statics.load)
revivals = 0        # retired static copies taken up again by new constants
retained_bytes = 0  # bytes the retired static copies and their sets' buffers hold
captures_by_kind: dict[str, int] = {}       # graphs captured, by their set's kind
capture_s_by_kind: dict[str, float] = {}    # their capture plus instantiate seconds

# the share of a device's memory that retired static copies and their
# sets' static buffers may hold (10 GB of an H100 80GB)
RETAINED_SHARE = 1 / 8

# the hand-written kernels' launch counters: (module, name)
_COUNTERS = ((gs, "launches"), (gs, "dots_launches"), (gs, "score_launches"),
             (fs, "launches"), (gst, "launches"), (gst, "dirs_launches"))

_sides: dict[tuple[int, int], torch.cuda.Stream] = {}
_own = WeakIdKeyDictionary()        # constants' V -> {key: Graphs}, sets of their own
_statics: dict = {}                 # (caller stream, layout) -> Statics, live or retired
_retired: OrderedDict = OrderedDict()   # key of a retired Statics -> (device, bytes), oldest first


def _counts() -> tuple[int, ...]:
    return tuple(getattr(m, k) for m, k in _COUNTERS)


def side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The capture stream that belongs to ``dev``'s current stream, made and
    warmed at first use."""
    caller = torch.cuda.current_stream(dev)
    key = (dev.index, caller.cuda_stream)
    side = _sides.get(key)
    if side is None:
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            gs.workspace(dev)
            for dt in (torch.float32, torch.float64):
                a = torch.ones((2, 2), dtype=dt, device=dev)
                a @ a[0]
                a @ a
        caller.wait_stream(side)
        side = _sides.setdefault(key, side)
    return side


class Graph:
    """One CUDA graph of ``fn()``, captured on ``stream`` into ``pool``, and
    the kernels' launches that its capture recorded."""

    def __init__(self, fn, stream: torch.cuda.Stream, pool, generators=()):
        global captures, capture_s, instantiate_s
        g = torch.cuda.CUDAGraph()
        for gen in generators:
            g.register_generator_state(gen)
        torch.cuda.synchronize(stream.device)
        before = _counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.stream(stream):
                g.capture_begin(pool=pool, capture_error_mode="global")
                try:
                    fn()
                finally:
                    t1 = time.perf_counter()
                    g.capture_end()         # ends the capture and instantiates
        finally:
            after = _counts()
            for (m, k), v in zip(_COUNTERS, before):
                setattr(m, k, v)
        t2 = time.perf_counter()
        capture_s += t1 - t0
        instantiate_s += t2 - t1
        captures += 1
        self.graph = g
        self.launches = tuple(a - b for a, b in zip(after, before))

    def replay(self) -> None:
        global replays
        self.graph.replay()
        replays += 1
        for (m, k), d in zip(_COUNTERS, self.launches):
            if d:
                setattr(m, k, getattr(m, k) + d)


def _tensors(tree):
    """The tensors of a nested tuple, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif tree is not None:
        for t in tree:
            yield from _tensors(t)


class Graphs:
    """The graphs of one static state (for a build: of one :func:`set_key`;
    a set of its own also remembers the ``tensors`` it was captured with),
    their static buffers ``static``, values derived from the constants
    (``derived``), the static copies of the constants that a shared set's
    graphs read (``consts``; None for a set of its own), the generator that
    they draw from (``gen``), and their shared memory pool.  ``warm``: run
    each key's work once directly before capturing it.  ``kind`` names the
    set's work in ``captures_by_kind``."""

    def __init__(self, tensors, static, derived, gen, warm: bool = False, consts=None, *,
                 kind: str):
        self.refs = tuple(weakref.ref(t) for t in tensors)
        self.gen = gen
        self.kind = kind
        self.static = static
        self.derived = derived
        self.derived_at = None      # the Statics.loads that ``derived`` was made at
        self.consts = consts
        self.device = next(_tensors(static)).device
        self.stream = side_stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}
        self.warm = warm
        self.warmed: set = set()

    def holds(self, tensors, gen) -> bool:
        return self.gen is gen and len(self.refs) == len(tensors) \
            and all(r() is t for r, t in zip(self.refs, tensors))

    def run(self, key, fn) -> None:
        """Replay the graph of ``key``, capturing ``fn()`` first if there
        is none yet (with ``warm``, running it directly the first time),
        in the spans ``graphs.capture`` (attr ``kind``) and
        ``graphs.replay`` (attrs ``kind`` and ``key``)."""
        g = self.graphs.get(key)
        if g is None:
            if self.warm and key not in self.warmed:
                self.warmed.add(key)
                caller = torch.cuda.current_stream(self.stream.device)
                self.stream.wait_stream(caller)
                with torch.cuda.stream(self.stream):
                    fn()
                caller.wait_stream(self.stream)
                return
            t0 = capture_s + instantiate_s
            with span("graphs.capture", device=self.device, kind=self.kind):
                g = Graph(fn, self.stream, self.pool, () if self.gen is None else (self.gen,))
            self.graphs[key] = g
            captures_by_kind[self.kind] = captures_by_kind.get(self.kind, 0) + 1
            capture_s_by_kind[self.kind] = (capture_s_by_kind.get(self.kind, 0.0)
                                            + capture_s + instantiate_s - t0)
        with span("graphs.replay", device=self.device, kind=self.kind, key=key):
            g.replay()


def layout(tensors) -> tuple:
    """What static copies of ``tensors`` must match, per tensor: its dtype,
    shape and strides, and the position of the first earlier tensor that is
    the same tensor (-1 if none), so that the copies keep that aliasing with
    one buffer per distinct tensor.  Needs no CUDA."""
    return tuple((t.dtype, tuple(t.shape), t.stride(),
                  next((j for j in range(i) if tensors[j] is t), -1))
                 for i, t in enumerate(tensors))


def set_key(tensors, key, stream, shared: bool) -> tuple:
    """The key of the graph set of the constants ``tensors`` under the
    caller's ``key`` on the caller ``stream`` ((device index, handle)):
    whether the set is shared, and for a shared one the constants'
    :func:`layout`, so that every constants of one layout get one set (a
    set of its own hangs off its constants instead).  Needs no CUDA."""
    return (shared, tuple(key), stream) + ((layout(tensors),) if shared else ())


class Statics:
    """Static copies of constants of one layout on one caller stream, which
    the graphs of every shared set on them (``sets``, by :func:`set_key`)
    read, and the constants that use them (``users``: weak references to
    each one's anchor, whose death retires the copies once none is left).
    Needs no CUDA."""

    def __init__(self, tensors, key):
        self.key = key
        self.device = tensors[0].device
        aliases = [alias for *_, alias in layout(tensors)]
        bufs = []
        for t, alias in zip(tensors, aliases):
            bufs.append(bufs[alias] if alias >= 0 else torch.empty_like(t))
        self.tensors = tuple(bufs)
        self.distinct = tuple(i for i, alias in enumerate(aliases) if alias < 0)
        self.stamps = ()        # (weak reference, version) of each tensor copied in last
        self.loads = 0          # copies made so far
        self.sets: dict = {}
        self.users: dict = {}

    def use(self, anchor) -> None:
        uid = id(anchor)
        if uid not in self.users:
            self.users[uid] = weakref.ref(anchor, functools.partial(_drop_user, self.key, uid))

    def load(self, tensors) -> bool:
        """Copy ``tensors`` into the static copies on the current stream,
        unless they are the tensors copied in last and none has been
        written since; returns whether it copied."""
        global loads
        if len(self.stamps) == len(tensors) and all(
                r() is t and v == t._version for (r, v), t in zip(self.stamps, tensors)):
            return False
        for i in self.distinct:
            self.tensors[i].copy_(tensors[i])
        self.stamps = tuple((weakref.ref(t), t._version) for t in tensors)
        self.loads += 1
        loads += 1
        return True

    def nbytes(self) -> int:
        """Bytes of the static copies and of their sets' static buffers and
        derived values."""
        ts = [self.tensors[i] for i in self.distinct]
        for e in self.sets.values():
            ts.extend(_tensors((e.static, e.derived)))
        return sum(t.numel() * t.element_size() for t in ts)


def _recount() -> None:
    global retained_bytes
    retained_bytes = sum(n for _, n in _retired.values())


def _drop_user(key, uid, ref) -> None:
    """A user's anchor died: forget it, and retire the static copies and
    their sets with the last one.  It frees nothing: it may run at any
    point, inside a capture too."""
    if _statics is None:                # the interpreter is shutting down
        return
    st = _statics.get(key)
    if st is not None and st.users.get(uid) is ref:
        del st.users[uid]
        if not st.users:
            _retired[key] = (st.device, st.nbytes())
            _recount()


def _drop(key) -> None:
    """Drop a retired entry: its static copies, its sets and their graphs."""
    del _retired[key]
    del _statics[key]


def _evict() -> None:
    """Drop the oldest retired entries of each device until the rest fit in
    :data:`RETAINED_SHARE` of its memory."""
    held: dict = {}
    for dev, n in _retired.values():
        held[dev] = held.get(dev, 0) + n
    for key, (dev, n) in list(_retired.items()):
        if held[dev] > RETAINED_SHARE * _memory(dev):
            _drop(key)
            held[dev] -= n
    _recount()


def _memory(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).total_memory


def release() -> None:
    """Drop every retired entry and return the device memory it held: the
    graphs' pools and the cached blocks go back to the device."""
    while _retired:
        _drop(next(iter(_retired)))
    _recount()
    torch.cuda.empty_cache()


def _statics_for(tensors, key) -> Statics:
    """The :class:`Statics` under ``key``, with ``tensors`` (anchored on the
    first) among its users and copied in: a retired one is revived, and
    one is made where there is none (after the retired entries over the
    budget are dropped)."""
    global revivals
    st = _statics.get(key)
    if st is not None:
        st.use(tensors[0])              # a live user first: nothing retires it now
        if _retired.pop(key, None) is not None:
            revivals += 1
    _evict()
    if st is None:
        st = _statics[key] = Statics(tensors, key)
        st.use(tensors[0])
    st.load(tensors)
    return st


def _stream(dev: torch.device) -> tuple[int, int]:
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def statics_of(tensors) -> Statics | None:
    """The static copies that shared sets of ``tensors``' layout read on
    the current stream, if there are any."""
    return _statics.get((_stream(tensors[0].device), layout(tensors)))


def graphs_for(tensors, key, gen, make_static, make_derived=lambda consts: None,
               warm: bool = False, shared: bool = False) -> Graphs:
    """The :class:`Graphs` of the constants ``tensors`` (the first one the
    anchor, the constants' ``V``) under ``key`` on the current stream, made
    with ``make_static()`` and ``warm`` where there is none.
    ``make_derived(constants)`` makes ``derived`` from the constants the
    graphs read.  ``key[0]`` names the set's kind (``captures_by_kind``).

    ``shared``: the set is shared by every constants of ``tensors``' layout
    (:func:`set_key`) and its graphs read the static copies ``consts``
    (:class:`Statics`), which ``tensors`` are copied into first where they
    are not the ones copied in last; ``derived`` is then made again into
    its buffers.  Where ``gen`` is not None its graphs draw from a
    generator of the set's own on the constants' device, which the caller
    loads with ``gen``'s state before the replays and takes it back from
    after (:func:`draw_from`).  Otherwise the set is the constants' own: its
    graphs read ``tensors`` themselves and draw from ``gen``, and it is
    made again when any of them is not the one it was captured with."""
    anchor = tensors[0]
    k = set_key(tensors, key, _stream(anchor.device), shared)
    if shared:
        st = _statics_for(tensors, k[2:])
        sets, consts, at = st.sets, st.tensors, st.loads
    else:
        _evict()
        sets = _own.get(anchor)
        if sets is None:
            sets = _own.setdefault(anchor, {})
        consts, at = tensors, 0
    e = sets.get(k)
    if e is None or not (shared or e.holds(tensors, gen)):
        own = None if gen is None else torch.Generator(device=anchor.device)
        e = sets[k] = Graphs(() if shared else tensors, make_static(), None,
                             own if shared else gen, warm, consts if shared else None,
                             kind=key[0])
    if e.derived_at != at:
        d = make_derived(consts)
        if e.derived_at is None:
            e.derived = d
        else:
            copy_into(e.derived, d)
        e.derived_at = at
    return e


@contextlib.contextmanager
def draw_from(e: Graphs, gen):
    """Replays of ``e`` inside the block draw what ``gen`` would draw: a
    generator of the set's own is loaded with ``gen``'s state (its seed and
    offset, which a CUDA generator keeps on the host) before, and ``gen``
    takes the state it reached back after.  A set that draws from ``gen``
    itself (or from none) needs neither."""
    own = e.gen is not gen
    if own:
        e.gen.set_state(gen.get_state())
    yield
    if own:
        gen.set_state(e.gen.get_state())


def copy_into(static, values) -> None:
    """Write ``values`` into the static buffers, nested tuples alike,
    skipping those that are the buffers themselves (which the work updated
    in place).  A value may be another buffer only if that one is written
    after it."""
    if isinstance(static, torch.Tensor):
        if values is not static:
            static.copy_(values)
        return
    if static is None:
        return
    for buf, v in zip(static, values):
        copy_into(buf, v)


def empty_like(tree):
    """Uninitialized buffers shaped as the tensors of the nested tuple
    ``tree`` (None stays None), each with its tensor's strides where those
    are dense (a factor from ``cholesky`` is column-major, and a solve
    against a row-major copy rounds otherwise), else contiguous."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree)
    if tree is None:
        return None
    return type(tree)(*(empty_like(t) for t in tree)) if hasattr(tree, "_fields") \
        else type(tree)(empty_like(t) for t in tree)


def clone(tree):
    """Copies of the tensors of the nested tuple ``tree`` (None stays
    None): a state taken out of the static buffers."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if tree is None:
        return None
    return type(tree)(*(clone(t) for t in tree)) if hasattr(tree, "_fields") \
        else type(tree)(clone(t) for t in tree)
