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
  A build's are cached per (constants, static key, caller stream) by
  :func:`graphs_for`: dropped with the constants' ``V`` (a weak key) and
  rebuilt when any other tensor of the constants, or the generator, is not
  the one it was captured with.  A NUTS run holds its own for the run's
  length, made on its first transition's carry.
- **Capture stream.**  Each caller stream has a side stream of its own,
  made and warmed once before its first capture: the select kernels'
  workspace for that stream (:func:`.giga_select.workspace`) and its
  cuBLAS handle are made there outside any capture.  Captures use
  ``capture_error_mode="global"``, so a host read or a synchronizing call
  inside one raises.  Replays run on the caller's current stream.
  ``capture_s`` and ``instantiate_s`` time the two halves of a capture.
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
- **Launch counts.**  The kernels' counters (:mod:`.giga_select`'s and
  :mod:`.fold_scale`'s) count wrapper calls, and a replay makes none: each
  graph keeps the launches that its capture recorded (and takes them back
  off the counters: a capture launches nothing) and adds them at every
  replay.
- **No fallback.**  A capture or replay that fails raises.
"""

from __future__ import annotations

import time
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import fold_scale as fs
from . import giga_select as gs

captures = 0        # graphs captured (since last set to 0)
capture_s = 0.0     # seconds spent capturing them (recording the work)
instantiate_s = 0.0     # seconds spent instantiating them
replays = 0         # graph replays

# the hand-written kernels' launch counters: (module, name)
_COUNTERS = ((gs, "launches"), (gs, "dots_launches"), (gs, "score_launches"),
             (fs, "launches"))

_sides: dict[tuple[int, int], torch.cuda.Stream] = {}
_cache = WeakIdKeyDictionary()      # constants' V -> {key: Graphs}


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
    """The graphs of one static state (for a build: of one (constants,
    static key, caller stream), the ``tensors`` they were captured with),
    their static buffers ``static``, constants derived once (``derived``),
    and their shared memory pool.  ``warm``: run each key's work once
    directly before capturing it."""

    def __init__(self, tensors, static, derived, gen, warm: bool = False):
        self.refs = tuple(weakref.ref(t) for t in tensors)
        self.gen = gen
        self.static = static
        self.derived = derived
        self.stream = side_stream(next(_tensors(static)).device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}
        self.warm = warm
        self.warmed: set = set()

    def holds(self, tensors, gen) -> bool:
        return self.gen is gen and len(self.refs) == len(tensors) \
            and all(r() is t for r, t in zip(self.refs, tensors))

    def run(self, key, fn) -> None:
        """Replay the graph of ``key``, capturing ``fn()`` first if there
        is none yet (with ``warm``, running it directly the first time)."""
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
            g = Graph(fn, self.stream, self.pool, () if self.gen is None else (self.gen,))
            self.graphs[key] = g
        g.replay()


def graphs_for(tensors, key, gen, make_static, make_derived=lambda: None,
               warm: bool = False) -> Graphs:
    """The :class:`Graphs` of the constants ``tensors`` (the first one the
    anchor, whose death drops them) under ``key`` on the current stream;
    made, with ``make_static()``, ``make_derived()`` and ``warm``, where
    there is none or it was captured with other tensors or generator
    ``gen``."""
    anchor = tensors[0]
    key = tuple(key) + (torch.cuda.current_stream(anchor.device).cuda_stream,)
    by_key = _cache.get(anchor)
    if by_key is None:
        by_key = _cache.setdefault(anchor, {})
    entry = by_key.get(key)
    if entry is None or not entry.holds(tensors, gen):
        entry = by_key[key] = Graphs(tensors, make_static(), make_derived(), gen, warm)
    return entry


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
