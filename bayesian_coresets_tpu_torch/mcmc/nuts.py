"""No-U-Turn Sampler with bounded-depth iterative tree building, over C chains.

Port of ``bayesian_coresets_tpu/mcmc/nuts.py`` (which replaces the
reference's Stan NUTS): the same iterative doubling with a binary-counter
checkpoint stack, progressive multinomial sampling within a subtree, biased
progressive sampling across doublings, a divergence threshold of 1000, and
the guard that never proposes a leaf with a non-finite position, log-density
or gradient.

JAX vmaps per-chain ``lax.while_loop``s; here the tree runs eagerly for all
chains at once.  Doubling j takes 2^j leaves for every chain still building
(all such chains are at the same depth, since they start together).  A
chain that turned or diverged is frozen by ``torch.where``: its trajectory
ends, proposal, weight and counters stay as they were, while the others go
on.  The loops end when no chain is left building: one host read per leaf
and one per doubling (``host_reads`` counts them).  With chains sharded
over ranks (``comm``, ``parallel/mcmc.py``) each read is of the flag over
every rank's chains, so all ranks take as many leaves as one process
taking every chain would, and their generators stay in step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .draws import as_draws
from .integrators import (IntegratorState, kinetic, leapfrog, mass_mul, per_chain,
                          sample_momentum, where_state)

DIVERGENCE_THRESHOLD = 1000.0

host_reads = 0     # loop-guard reads of a device flag by nuts_kernel
leaf_steps = 0     # batched leapfrog steps taken by nuts_kernel (one per leaf)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor   # (C,) mean leapfrog acceptance statistic
    diverging: torch.Tensor     # (C,) bool
    depth: torch.Tensor         # (C,) tree depth reached
    num_steps: torch.Tensor     # (C,) leapfrog steps taken


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    return _popcount(n & ~(n + 1))


def _any(flags: torch.Tensor, comm=None) -> bool:
    global host_reads
    host_reads += 1
    return bool(flags.any()) if comm is None else comm.any(flags)


def _is_turning(z_minus, r_minus, z_plus, r_plus, inv_mass) -> torch.Tensor:
    """Original NUTS U-turn criterion under the metric, per chain."""
    dz = z_plus - z_minus
    return ((torch.sum(dz * mass_mul(inv_mass, r_minus), dim=-1) < 0)
            | (torch.sum(dz * mass_mul(inv_mass, r_plus), dim=-1) < 0))


class _Subtree(NamedTuple):
    s: IntegratorState          # outermost point
    prop: IntegratorState       # subtree proposal
    logw: torch.Tensor          # logsumexp of the leaf weights
    sum_accept: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    i: torch.Tensor             # leaves taken


def _build_subtree(value_and_grad_fn, start: IntegratorState, num_steps: int, step,
                   inv_mass, joint0, max_depth: int, draws, building, comm=None) -> _Subtree:
    """Up to ``num_steps`` leapfrog steps from ``start`` for the chains in
    ``building``; a chain stops at its first U-turn or divergence."""
    global leaf_steps
    C, d = start.z.shape
    dev, f32 = start.z.device, torch.float32
    ckpt_z = torch.zeros((C, max_depth, d), dtype=start.z.dtype, device=dev)
    ckpt_r = torch.zeros_like(ckpt_z)
    s, prop = start, start
    logw = torch.full((C,), float("-inf"), dtype=f32, device=dev)
    sum_accept = torch.zeros((C,), dtype=f32, device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    i = torch.zeros((C,), dtype=torch.int32, device=dev)
    run = building
    for leaf in range(num_steps):
        if leaf and not _any(run, comm):
            break
        leaf_steps += 1
        new = leapfrog(value_and_grad_fn, s, step, inv_mass)
        logw_leaf = new.logp - kinetic(new.r, inv_mass) - joint0
        # a leaf with a non-finite position or gradient is never proposed,
        # even when its logp is finite: a cached inf gradient poisons every
        # later leapfrog and step-size search of its chain
        finite = (torch.isfinite(new.logp) & torch.isfinite(new.grad).all(dim=-1)
                  & torch.isfinite(new.z).all(dim=-1))
        logw_leaf = torch.where(torch.isnan(logw_leaf) | ~finite, float("-inf"), logw_leaf)
        div = logw_leaf < -DIVERGENCE_THRESHOLD
        accept = torch.clamp(torch.exp(torch.clamp(logw_leaf, max=0.0)), max=1.0)

        # progressive multinomial proposal within the subtree
        u = draws.leaf_uniform(C, dev)
        new_logw = torch.logaddexp(logw, logw_leaf)
        take = u < torch.exp(logw_leaf - new_logw)

        # binary-counter checkpoints: every running chain is at leaf `leaf`
        if leaf % 2 == 0:
            slot = min(_popcount(leaf), max_depth - 1)
            ckpt_z[:, slot] = new.z
            ckpt_r[:, slot] = new.r
            turn = torch.zeros_like(turning)
        else:
            hi = _popcount(leaf) - 1
            lo = hi - _trailing_ones(leaf) + 1
            dz = new.z[:, None, :] - ckpt_z[:, lo:hi + 1]
            t_minus = torch.sum(dz * mass_mul(inv_mass, ckpt_r[:, lo:hi + 1]), dim=-1) < 0
            t_plus = torch.sum(dz * mass_mul(inv_mass, new.r)[:, None, :], dim=-1) < 0
            turn = torch.any(t_minus | t_plus, dim=1)

        # commit for the running chains only
        prop = where_state(run & take, new, prop)
        s = where_state(run, new, s)
        logw = torch.where(run, new_logw, logw)
        sum_accept = sum_accept + torch.where(run, accept, 0.0)
        turning = turning | (run & turn)
        diverging = torch.where(run, div, diverging)
        i = i + run.to(torch.int32)
        run = run & ~turning & ~diverging
    return _Subtree(s, prop, logw, sum_accept, turning, diverging, i)


def nuts_kernel(value_and_grad_fn: Callable, draws, state: IntegratorState,
                step_size, inv_mass: torch.Tensor, max_depth: int = 10,
                inv_mass_chol: torch.Tensor | None = None, comm=None):
    """One NUTS transition for every chain.  ``state.r`` is ignored (fresh
    momentum drawn); ``draws`` is a draw source or a ``torch.Generator``;
    ``step_size`` is a scalar or (C,); ``inv_mass_chol`` an optional
    precomputed ``mass_chol(inv_mass)``; ``comm`` the chain axis's
    exchanges when the chains are this rank's block."""
    draws = as_draws(draws)
    C, d = state.z.shape
    dev, f32 = state.z.device, torch.float32
    r0 = sample_momentum(draws, inv_mass, state.z.shape, state.z.dtype, chol=inv_mass_chol)
    s0 = IntegratorState(state.z, r0, state.logp, state.grad)
    joint0 = s0.logp - kinetic(r0, inv_mass)
    step = per_chain(step_size, state.logp)

    left = right = prop = s0
    logw = torch.zeros((C,), dtype=f32, device=dev)
    depth = torch.zeros((C,), dtype=torch.int32, device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros((C,), dtype=f32, device=dev)
    num_steps = torch.zeros((C,), dtype=torch.int32, device=dev)
    for j in range(max_depth):
        building = ~turning & ~diverging
        if j and not _any(building, comm):
            break
        go_right = draws.direction(C, dev)
        start = where_state(go_right, right, left)
        sub = _build_subtree(value_and_grad_fn, start, 1 << j,
                             torch.where(go_right, step, -step), inv_mass, joint0,
                             max_depth, draws, building, comm)
        u = draws.tree_uniform(C, dev)

        ok = ~sub.turning & ~sub.diverging
        # biased progressive sampling across doublings (Stan)
        take = building & ok & (u < torch.clamp(torch.exp(sub.logw - logw), max=1.0))
        prop = where_state(take, sub.prop, prop)
        logw = torch.where(building & ok, torch.logaddexp(logw, sub.logw), logw)
        left = where_state(building & ~go_right, sub.s, left)
        right = where_state(building & go_right, sub.s, right)
        whole_turn = ok & _is_turning(left.z, left.r, right.z, right.r, inv_mass)
        depth = depth + building.to(torch.int32)
        turning = torch.where(building, sub.turning | whole_turn, turning)
        diverging = torch.where(building, sub.diverging, diverging)
        sum_accept = sum_accept + torch.where(building, sub.sum_accept, 0.0)
        num_steps = num_steps + torch.where(building, sub.i, 0)

    new_state = IntegratorState(prop.z, torch.zeros_like(r0), prop.logp, prop.grad)
    n = torch.clamp(num_steps, min=1)
    info = NUTSInfo(sum_accept / n, diverging, depth, num_steps)
    return new_state, info
