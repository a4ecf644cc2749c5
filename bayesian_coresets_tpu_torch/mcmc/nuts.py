"""No-U-Turn Sampler with bounded-depth iterative tree building, over C chains.

Port of ``bayesian_coresets_tpu/mcmc/nuts.py`` (which replaces the
reference's Stan NUTS): the same iterative doubling with a binary-counter
checkpoint stack, progressive multinomial sampling within a subtree, biased
progressive sampling across doublings, a divergence threshold of 1000, and
the guard that never proposes a leaf with a non-finite position, log-density
or gradient.

JAX vmaps per-chain ``lax.while_loop``s; here the tree runs for all chains
at once.  Doubling j takes 2^j leaves for every chain still building (all
such chains are at the same depth, since they start together).  A chain
that turned or diverged is frozen by ``torch.where``: its trajectory ends,
proposal, weight and counters stay as they were, while the others go on.

The leaf body is one function of device values, as the JAX kernel's is:
each chain's leaf counter ``i`` picks its checkpoint slot (popcount(i) for
an even leaf, a masked write over all ``max_depth`` slots) and the slots an
odd leaf checks (a mask over all slots), and its row of the doubling's leaf
uniforms.  A leaf in which no chain runs changes nothing.  So the leaves
run in segments of K (``segment``) with one host read of "does any chain
still run" between segments, and a doubling ends at the first read that
finds none, or after its 2^j leaves; one more read per doubling asks
whether any chain still builds.  Every K gives the same transition bit for
bit: the draws do not depend on where the host reads (``draws.py``).

On a CUDA device (:class:`Transitions`, which ``run_nuts`` uses) the
transition's pieces are replayed CUDA graphs (:mod:`..ops.graphs`): its
start, a doubling's start (one graph per j), a segment of K leaves and a
doubling's merge, all on one set of static buffers, the gradient autograd's
inside the graphs.  ``host_reads`` counts the reads of a device flag and
``leaf_steps`` the batched leaves run, gated ones included.  With chains
sharded over ranks (``comm``, ``parallel/mcmc.py``) each read is of the
flag over every rank's chains, so all ranks take as many leaves as one
process taking every chain would, and their generators stay in step; such
runs are not captured.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops import graphs as cuda_graphs
from .draws import Draws, as_draws
from .integrators import (IntegratorState, kinetic, leapfrog, mass_chol, mass_mul, per_chain,
                          sample_momentum, where_state)

DIVERGENCE_THRESHOLD = 1000.0
SEGMENT = 1         # leaves per replayed graph on a CUDA device

host_reads = 0     # reads of a device flag by the transitions' loop guards
leaf_steps = 0     # batched leapfrog steps run by the transitions (gated ones included)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor   # (C,) mean leapfrog acceptance statistic
    diverging: torch.Tensor     # (C,) bool
    depth: torch.Tensor         # (C,) tree depth reached
    num_steps: torch.Tensor     # (C,) leapfrog steps taken


class _Tree(NamedTuple):
    """A transition's carry across doublings."""
    left: IntegratorState
    right: IntegratorState
    prop: IntegratorState
    logw: torch.Tensor
    depth: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_steps: torch.Tensor
    building: torch.Tensor      # ~turning & ~diverging: the chains the next doubling extends
    joint0: torch.Tensor


class _Subtree(NamedTuple):
    """A doubling's carry across its leaves, and what its leaves read."""
    s: IntegratorState          # outermost point
    prop: IntegratorState       # subtree proposal
    logw: torch.Tensor          # logsumexp of the leaf weights
    sum_accept: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    i: torch.Tensor             # (C,) int32 leaves taken
    run: torch.Tensor           # (C,) bool still running
    ckpt_z: torch.Tensor        # (C, max_depth, d) even leaves' positions
    ckpt_r: torch.Tensor        # (C, max_depth, d) even leaves' momenta
    step: torch.Tensor          # (C,) signed step
    u: torch.Tensor             # (2^j, C) leaf uniforms (a graph's buffer: 2^(max_depth-1) rows)
    go_right: torch.Tensor
    tree_u: torch.Tensor        # (C,) uniforms of the proposal across doublings


class _Carry(NamedTuple):
    """A transition's inputs and carry: the static buffers of its graphs."""
    z: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    step: torch.Tensor          # (C,)
    inv_mass: torch.Tensor
    chol: torch.Tensor
    tree: _Tree | None
    sub: _Subtree | None


def _any(flags: torch.Tensor, comm=None) -> bool:
    global host_reads
    host_reads += 1
    return bool(flags.any()) if comm is None else comm.any(flags)


def _is_turning(z_minus, r_minus, z_plus, r_plus, inv_mass) -> torch.Tensor:
    """Original NUTS U-turn criterion under the metric, per chain."""
    dz = z_plus - z_minus
    return ((torch.sum(dz * mass_mul(inv_mass, r_minus), dim=-1) < 0)
            | (torch.sum(dz * mass_mul(inv_mass, r_plus), dim=-1) < 0))


def _begin(draws, c: _Carry) -> _Carry:
    """Fresh momentum and the one-point tree."""
    C = c.z.shape[0]
    dev, f32 = c.z.device, torch.float32
    r0 = sample_momentum(draws, c.inv_mass, c.z.shape, c.z.dtype, chol=c.chol)
    s0 = IntegratorState(c.z, r0, c.logp, c.grad)
    zeros = torch.zeros((C,), dtype=f32, device=dev)
    never = torch.zeros((C,), dtype=torch.bool, device=dev)
    none = torch.zeros((C,), dtype=torch.int32, device=dev)
    tree = _Tree(s0, s0, s0, zeros, none, never, never, zeros, none,
                 torch.ones((C,), dtype=torch.bool, device=dev),
                 c.logp - kinetic(r0, c.inv_mass))
    return c._replace(tree=tree)


def _open(draws, j: int, max_depth: int, c: _Carry) -> _Carry:
    """Doubling j's draws and its subtree's start, for the chains still
    building.  The checkpoints carry over: a leaf reads only slots that
    its own subtree wrote."""
    t = c.tree
    C, d = c.z.shape
    dev, f32 = c.z.device, torch.float32
    go_right = draws.direction(C, dev)
    tree_u = draws.tree_uniform(C, dev)
    u = draws.leaf_uniforms(1 << j, C, dev)
    if c.sub is None:
        ckpt_z = torch.zeros((C, max_depth, d), dtype=c.z.dtype, device=dev)
        ckpt_r = torch.zeros_like(ckpt_z)
    else:
        ckpt_z, ckpt_r = c.sub.ckpt_z, c.sub.ckpt_r
    start = where_state(go_right, t.right, t.left)
    never = torch.zeros((C,), dtype=torch.bool, device=dev)
    sub = _Subtree(start, start, torch.full((C,), float("-inf"), dtype=f32, device=dev),
                   torch.zeros((C,), dtype=f32, device=dev), never, never,
                   torch.zeros((C,), dtype=torch.int32, device=dev), t.building,
                   ckpt_z, ckpt_r, torch.where(go_right, c.step, -c.step), u, go_right, tree_u)
    return c._replace(sub=sub)


def _leaf(vg, inv_mass, joint0, max_depth: int, b: _Subtree) -> _Subtree:
    """One leapfrog step for the chains in ``b.run``, with nothing that
    depends on the leaf's position but ``b.i``."""
    new = leapfrog(vg, b.s, b.step, inv_mass)
    logw_leaf = new.logp - kinetic(new.r, inv_mass) - joint0
    # a leaf with a non-finite position or gradient is never proposed,
    # even when its logp is finite: a cached inf gradient poisons every
    # later leapfrog and step-size search of its chain
    finite = (torch.isfinite(new.logp) & torch.isfinite(new.grad).all(dim=-1)
              & torch.isfinite(new.z).all(dim=-1))
    logw_leaf = torch.where(torch.isnan(logw_leaf) | ~finite, float("-inf"), logw_leaf)
    div = logw_leaf < -DIVERGENCE_THRESHOLD
    accept = torch.clamp(torch.exp(torch.clamp(logw_leaf, max=0.0)), max=1.0)

    # progressive multinomial proposal within the subtree: leaf i's uniform
    u = b.u.gather(0, b.i.clamp(max=b.u.shape[0] - 1).long()[None])[0]
    new_logw = torch.logaddexp(b.logw, logw_leaf)
    take = u < torch.exp(logw_leaf - new_logw)

    # binary-counter checkpoints (JAX nuts.py:108-125): an even leaf i
    # writes slot popcount(i); an odd one checks slots
    # [popcount(i) - trailing_ones(i), popcount(i) - 1]
    slots = torch.arange(max_depth, dtype=torch.int32, device=b.i.device)
    bits = (b.i[:, None] >> slots) & 1
    ones = bits.sum(dim=1)
    odd = bits[:, 0] == 1
    write = ((b.run & ~odd)[:, None]
             & (slots == torch.clamp(ones, max=max_depth - 1)[:, None]))[..., None]
    ckpt_z = torch.where(write, new.z[:, None, :], b.ckpt_z)
    ckpt_r = torch.where(write, new.r[:, None, :], b.ckpt_r)
    lo = ones - bits.cumprod(dim=1).sum(dim=1)
    in_range = odd[:, None] & (slots >= lo[:, None]) & (slots < ones[:, None])
    dz = new.z[:, None, :] - ckpt_z
    t_minus = torch.sum(dz * mass_mul(inv_mass, ckpt_r), dim=-1) < 0
    t_plus = torch.sum(dz * mass_mul(inv_mass, new.r)[:, None, :], dim=-1) < 0
    turn = torch.any(in_range & (t_minus | t_plus), dim=1)

    # commit for the running chains only
    run = b.run
    turning = b.turning | (run & turn)
    diverging = torch.where(run, div, b.diverging)
    return b._replace(prop=where_state(run & take, new, b.prop), s=where_state(run, new, b.s),
                      logw=torch.where(run, new_logw, b.logw),
                      sum_accept=b.sum_accept + torch.where(run, accept, 0.0),
                      turning=turning, diverging=diverging, i=b.i + run.to(torch.int32),
                      run=run & ~turning & ~diverging, ckpt_z=ckpt_z, ckpt_r=ckpt_r)


def _leaves(vg, n: int, max_depth: int, c: _Carry) -> _Carry:
    sub = c.sub
    for _ in range(n):
        sub = _leaf(vg, c.inv_mass, c.tree.joint0, max_depth, sub)
    return c._replace(sub=sub)


def _merge(c: _Carry) -> _Carry:
    """Doubling's end: biased progressive sampling across doublings (Stan),
    the new end point, and the U-turn of the whole trajectory."""
    t, b = c.tree, c.sub
    building, go_right = t.building, b.go_right
    ok = ~b.turning & ~b.diverging
    take = building & ok & (b.tree_u < torch.clamp(torch.exp(b.logw - t.logw), max=1.0))
    left = where_state(building & ~go_right, b.s, t.left)
    right = where_state(building & go_right, b.s, t.right)
    whole_turn = ok & _is_turning(left.z, left.r, right.z, right.r, c.inv_mass)
    turning = torch.where(building, b.turning | whole_turn, t.turning)
    diverging = torch.where(building, b.diverging, t.diverging)
    tree = _Tree(left, right, where_state(take, b.prop, t.prop),
                 torch.where(building & ok, torch.logaddexp(t.logw, b.logw), t.logw),
                 t.depth + building.to(torch.int32), turning, diverging,
                 t.sum_accept + torch.where(building, b.sum_accept, 0.0),
                 t.num_steps + torch.where(building, b.i, 0), ~turning & ~diverging, t.joint0)
    return c._replace(tree=tree)


def _end(c: _Carry):
    """The new state and the transition's info, in tensors of their own."""
    t = c.tree
    prop = t.prop
    new_state = IntegratorState(prop.z.clone(), torch.zeros_like(prop.r), prop.logp.clone(),
                                prop.grad.clone())
    n = torch.clamp(t.num_steps, min=1)
    return new_state, NUTSInfo(t.sum_accept / n, t.diverging.clone(), t.depth.clone(),
                               t.num_steps.clone())


def _direct(key, fn, c):
    return fn(c)


def _put(static: _Carry, c: _Carry) -> None:
    """Copy a piece's carry into the static buffers; a doubling's leaf
    uniforms fill the first rows of theirs."""
    u = c.sub.u if c.sub is not None else None
    if u is not None and u.shape[0] != static.sub.u.shape[0]:
        static = static._replace(sub=static.sub._replace(u=static.sub.u[:u.shape[0]]))
    cuda_graphs.copy_into(static, c)


class Transitions:
    """NUTS transitions of one set of C chains, one call each.

    ``segment``: leaves between two reads (default: ``SEGMENT`` when the
    transitions replay graphs, else 1).  ``graphs`` (default: on a CUDA
    device without ``comm``) replays captured CUDA graphs: the first call
    runs directly and its carry shapes the static buffers; each piece then
    runs once directly on the capture stream (warm-up) and is captured the
    next time it comes (one graph per doubling index that occurs twice,
    per segment length and for the start and the merge: a bounded number
    for the run).  Replays draw from ``draws``' generator, which must be a
    ``torch.Generator`` on the chains' device (registered with each
    graph), and give what the direct transitions give, bit for bit.
    ``graphs=False`` runs every piece directly (the reference).  A capture
    or replay that fails raises.
    """

    def __init__(self, value_and_grad_fn: Callable, draws, max_depth: int = 10,
                 segment: int | None = None, graphs: bool | None = None, comm=None):
        self.vg, self.draws, self.max_depth = value_and_grad_fn, as_draws(draws), max_depth
        self.segment, self.graphs, self.comm = segment, graphs, comm
        self.replayer = None        # the run's ops.graphs.Graphs, made after the first call

    def _replaying(self, dev: torch.device) -> bool:
        if self.graphs is None:
            self.graphs = dev.type == "cuda" and self.comm is None
        if self.graphs:
            if dev.type != "cuda" or self.comm is not None:
                raise ValueError("replayed NUTS transitions need CUDA chains on one process "
                                 f"(chains on {dev}, comm {self.comm!r}); pass graphs=False")
            if type(self.draws) is not Draws:
                raise ValueError("replayed NUTS transitions draw from a torch.Generator; got "
                                 f"the draw source {type(self.draws).__name__} (pass "
                                 "graphs=False to run the transitions directly)")
            self.draws._on(dev)
        if self.segment is None:
            self.segment = SEGMENT if self.graphs else 1
        if self.segment < 1:
            raise ValueError(f"segment must be at least 1, got {self.segment}")
        return self.graphs

    def __call__(self, state: IntegratorState, step_size, inv_mass: torch.Tensor,
                 inv_mass_chol: torch.Tensor | None = None):
        """One transition from ``state`` (``state.r`` is ignored: fresh
        momentum is drawn); ``step_size`` a scalar or (C,); returns the new
        state and its :class:`NUTSInfo`."""
        chol = mass_chol(inv_mass) if inv_mass_chol is None else inv_mass_chol
        c = _Carry(state.z, state.logp, state.grad, per_chain(step_size, state.logp), inv_mass,
                   chol, None, None)
        if not self._replaying(state.z.device):
            return _end(self._transition(c, _direct))
        if self.replayer is None:
            c = self._transition(c, _direct)
            static = cuda_graphs.empty_like(c)
            rows = 1 << (self.max_depth - 1)
            static = static._replace(sub=static.sub._replace(
                u=static.sub.u.new_empty((rows,) + tuple(static.sub.u.shape[1:]))))
            self.replayer = cuda_graphs.Graphs((), static, None, self.draws.gen, warm=True,
                                               kind="nuts")
            return _end(c)
        st = self.replayer.static
        cuda_graphs.copy_into(st[:6], c[:6])
        return _end(self._transition(st, self._replay))

    def _replay(self, key, fn, st: _Carry) -> _Carry:
        self.replayer.run(key, lambda: _put(st, fn(st)))
        return st

    def _transition(self, c: _Carry, run) -> _Carry:
        global leaf_steps
        draws, D, K, comm = self.draws, self.max_depth, self.segment, self.comm
        c = run("begin", lambda c: _begin(draws, c), c)
        for j in range(D):
            if j and not _any(c.tree.building, comm):
                break
            c = run(("open", j), lambda c: _open(draws, j, D, c), c)
            n = 1 << j
            for lo in range(0, n, K):
                if lo and not _any(c.sub.run, comm):
                    break
                L = min(K, n - lo)
                leaf_steps += L
                c = run(("leaves", L), lambda c: _leaves(self.vg, L, D, c), c)
            c = run("merge", _merge, c)
        return c


def nuts_kernel(value_and_grad_fn: Callable, draws, state: IntegratorState,
                step_size, inv_mass: torch.Tensor, max_depth: int = 10,
                inv_mass_chol: torch.Tensor | None = None, comm=None):
    """One NUTS transition for every chain, run directly (no graphs; a run
    of many goes through :class:`Transitions`).  ``state.r`` is ignored
    (fresh momentum drawn); ``draws`` is a draw source or a
    ``torch.Generator``; ``step_size`` is a scalar or (C,);
    ``inv_mass_chol`` an optional precomputed ``mass_chol(inv_mass)``;
    ``comm`` the chain axis's exchanges when the chains are this rank's
    block."""
    return Transitions(value_and_grad_fn, draws, max_depth, 1, False, comm)(
        state, step_size, inv_mass, inv_mass_chol)
