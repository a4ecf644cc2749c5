"""Projected Adam for (partially) nonnegativity-constrained objectives.

Port of ``bayesian_coresets_tpu/ops/opt.py`` (reference util/opt.py:4-28):
the bias-corrected Adam update ``step_sched(i) * m1_hat / (eps +
sqrt(m2_hat))`` followed by clamping the constrained coordinates at zero.
SparseVI and BatchPSVI redraw Monte Carlo samples inside every gradient
evaluation, so the gradient callback is handed the draw source (a
``torch.Generator``) at every step; it advances, so every step draws fresh
values.

The JAX package runs the steps as one ``lax.scan``.  Here the loop body is
:func:`_step`, on device values alone: the state ``(x, m1, m2, aux, i)`` is
one nested tuple (:class:`State`) whose step index ``i`` is a device int
tensor, and the step constants (``step_sched(i)`` and the bias corrections
``1 - b**(i+1)``, computed once per call as f32 tensors over an f32 step
index, as the JAX package computes them) are read at ``i`` with
``index_select``, never with a Python index.  :func:`nn_opt` runs the steps
in segments of ``segment`` steps (:func:`_segment`) and reads nothing back
between them.  On a CUDA device each segment is a replayed CUDA graph
(:mod:`.graphs`; the remainder of ``opt_itrs % segment`` steps is a tail
graph of its own), with the caller's generator registered, so a replay
draws what the same steps draw directly and every segment length gives the
same iterates bit for bit.  The update divides only by tensors (CUDA
divides by a Python scalar by multiplying with its reciprocal, the CPU
does not).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import config
from . import graphs as cuda_graphs

# Adam steps per replayed segment, chosen by measurement on an H100
# (scripts/profile_torch_svi.py, PERF.md): graphs of 10 steps (~800 nodes
# for the Gaussian families, ~2200 for the logistic Laplace refit) replay
# the Gaussian steps as fast as graphs of 25 (within 3%) and faster than
# graphs of 50 or 100, the logistic ones alike, and capture in 0.02-0.07 s
SEGMENT = 10

steps_run = 0       # Adam steps run by nn_opt (since last set to 0)


class State(NamedTuple):
    """The carry of the steps."""

    x: torch.Tensor       # the iterate
    m1: torch.Tensor      # first moment
    m2: torch.Tensor      # second moment
    aux: object           # the caller's carried state (nested tensors, or None)
    i: torch.Tensor       # int64 step index (0-dim, on x's device)


class Sched(NamedTuple):
    """What the steps read and never write: the per-step constants, the
    constraint mask and the caller's inputs."""

    lr: torch.Tensor      # (opt_itrs,) step_sched over the f32 step index
    c1: torch.Tensor      # (opt_itrs,) 1 - b1**(i+1)
    c2: torch.Tensor      # (opt_itrs,) 1 - b2**(i+1)
    mask: torch.Tensor    # True where x is clamped at 0
    inputs: object        # handed to grad_fn (nested tensors, or None)


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``v[i]`` for a 0-dim device index, read on the device."""
    return v.index_select(0, i.view(1)).view(())


def _step(grad_fn, gen, hyper, s: State, p: Sched) -> State:
    """One projected-Adam step (``body`` of the JAX package's scan,
    ops/opt.py:44-57 there)."""
    b1, b2, eps = hyper
    if p.inputs is not None:
        g, aux = grad_fn(s.x, gen, s.aux, p.inputs)
    elif s.aux is not None:
        g, aux = grad_fn(s.x, gen, s.aux)
    else:
        g, aux = grad_fn(s.x, gen), None
    m1 = b1 * s.m1 + (1.0 - b1) * g
    m2 = b2 * s.m2 + (1.0 - b2) * g * g
    m1_hat = m1 / _at(p.c1, s.i)
    m2_hat = m2 / _at(p.c2, s.i)
    x = s.x - _at(p.lr, s.i) * m1_hat / (eps + torch.sqrt(m2_hat))
    x = torch.where(p.mask, torch.clamp_min(x, 0.0), x)
    return State(x, m1, m2, aux, s.i + 1)


def _segment(grad_fn, gen, hyper, n: int, s: State, p: Sched) -> State:
    """``n`` steps from ``s`` on device values alone."""
    for _ in range(n):
        s = _step(grad_fn, gen, hyper, s, p)
    return s


def segments(opt_itrs: int, segment: int):
    """The lengths of the segments of ``opt_itrs`` steps: whole ones, then
    the tail."""
    whole, tail = divmod(int(opt_itrs), int(segment))
    return [int(segment)] * whole + ([tail] if tail else [])


def replaying(dev: torch.device, graphs: bool | None) -> bool:
    """Whether steps on ``dev`` replay CUDA graphs: by default (``graphs``
    None) on a CUDA device; ``True`` elsewhere raises."""
    if graphs is None:
        return dev.type == "cuda"
    if graphs and dev.type != "cuda":
        raise ValueError(f"replayed Adam steps need a CUDA device (the iterate is on {dev}); "
                         "pass graphs=False")
    return bool(graphs)


def nn_opt(
    x0: torch.Tensor,
    grad_fn: Callable,                    # (x, gen) -> grad, or with aux/inputs below
    gen: torch.Generator,
    nn_mask: torch.Tensor | None = None,  # True where x is constrained >= 0
    opt_itrs: int = 1000,
    step_sched: Callable = lambda i: 1.0 / (1.0 + i),
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    aux0=None,                            # carried state threaded through the steps
    *,
    inputs=None,
    graphs: bool | None = None,
    segment: int | None = None,
    cache=None,
):
    """Run ``opt_itrs`` projected-Adam steps; returns the final iterate.

    ``nn_mask=None`` clamps every coordinate.  ``step_sched`` is called
    once, on the f32 tensor of step indices 0..opt_itrs-1 (a constant
    schedule may return a number).  With ``aux0`` given,
    ``grad_fn(x, gen, aux) -> (grad, aux)`` threads a carried state through
    the steps and ``(x, aux)`` is returned.  ``inputs`` (nested tensors)
    are handed to every step, ``grad_fn(x, gen, aux, inputs) -> (grad,
    aux)``: what a step reads that changes between calls, which a replayed
    graph must find in its static buffers.

    ``segment``: steps between two graph launches (default
    :data:`SEGMENT`).  ``graphs`` (default: on a CUDA device) replays each
    segment as a CUDA graph (:mod:`.graphs`, ``warm=True``: each length's
    first segment runs directly on the capture stream, the next one is
    captured); ``gen`` must then be a ``torch.Generator`` on ``x0``'s
    device, and ``grad_fn`` must read no value back to the host (a capture
    raises on it).  ``graphs=False`` runs the same segments directly.
    Every segment length, replayed or direct, gives the same result bit
    for bit.  ``cache``: ``(tensors, key)`` under which the graphs are kept
    (:func:`.graphs.graphs_for`, anchored on the first tensor) for later
    calls with the same shapes, generator and hyperparameters (``key``
    must tell every ``grad_fn`` that computes something else apart);
    without it each call captures its own.
    """
    global steps_run
    dt, dev = x0.dtype, x0.device
    mask = torch.ones_like(x0, dtype=torch.bool) if nn_mask is None else nn_mask
    steps = torch.arange(opt_itrs, dtype=dt, device=dev)
    lr = torch.as_tensor(step_sched(steps), dtype=dt, device=dev).expand(opt_itrs).contiguous()
    c1 = 1.0 - torch.pow(b1, steps + 1.0)
    c2 = 1.0 - torch.pow(b2, steps + 1.0)
    hyper = (b1, b2, eps)
    p = Sched(lr, c1, c2, mask, inputs)
    s = State(x0, torch.zeros_like(x0), torch.zeros_like(x0), aux0,
              torch.zeros((), dtype=torch.int64, device=dev))
    K = SEGMENT if segment is None else int(segment)
    if K < 1:
        raise ValueError(f"segment must be at least 1, got {segment}")
    plan = segments(opt_itrs, K)
    steps_run += int(opt_itrs)
    if plan and replaying(dev, graphs):
        s = _replay(grad_fn, gen, hyper, plan, s, p, cache)
    else:
        for n in plan:
            s = _segment(grad_fn, gen, hyper, n, s, p)
    return (s.x, s.aux) if aux0 is not None else s.x


def _replay(grad_fn, gen, hyper, plan, s: State, p: Sched, cache) -> State:
    """The segments of ``plan`` as replayed CUDA graphs on static buffers
    holding ``(s, p)``; returns the state copied out of them."""
    dev = s.x.device
    if not isinstance(gen, torch.Generator) or config.resolve_device(gen.device) != dev:
        raise ValueError("replayed Adam steps draw from a torch.Generator on the iterate's "
                         f"device ({dev}); got {gen!r} (pass graphs=False to run the steps "
                         "directly)")
    if cache is None:
        e = cuda_graphs.Graphs((), cuda_graphs.empty_like((s, p)), None, gen, warm=True,
                               kind="nn_opt")
    else:
        tensors, key = cache
        key = ("nn_opt", hyper, _shapes((s, p))) + tuple(key)
        e = cuda_graphs.graphs_for(tuple(tensors), key, gen,
                                   lambda: cuda_graphs.empty_like((s, p)), warm=True)
    cuda_graphs.copy_into(e.static, (s, p))
    st, sp = e.static
    for n in plan:
        e.run(n, lambda n=n: cuda_graphs.copy_into(st, _segment(grad_fn, gen, hyper, n, st, sp)))
    return cuda_graphs.clone(st)


def _shapes(tree):
    """The (dtype, shape, strides) of the tensors of a nested tuple, and
    where its Nones are: what a graph's static buffers must match."""
    if isinstance(tree, torch.Tensor):
        return (tree.dtype, tuple(tree.shape), tree.stride())
    if tree is None:
        return None
    return tuple(_shapes(t) for t in tree)
