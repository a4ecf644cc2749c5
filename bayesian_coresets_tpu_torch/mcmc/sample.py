"""NUTS driver: warmup and sampling for C chains at once.

Port of ``bayesian_coresets_tpu/mcmc/sample.py`` (which replaces the
reference's pystan driver, examples/common/mcmc.py:58-68).  JAX vmaps one
chain's warmup and sampling scans; here every step is one batched NUTS
transition of all chains.  Adaptation runs per chain by default (each
chain its own dual averaging, Welford state and metric) or pooled across
chains (one step size and one metric for all).

With ``comm`` (the chain axis of a mesh, ``parallel/mcmc.py``) the chains
are this rank's block of all C: every draw is made for all C chains from a
generator that steps alike on every rank, and the block kept
(:class:`.draws.BlockDraws`); the loops' guards read every rank's chains;
pooled adaptation takes its statistics (the mean acceptance, the Welford
batch merge, the median reasonable step) from the chains of every rank,
gathered by one (C, ...) exchange each, so each rank computes what one
process computes.  Per-chain adaptation exchanges nothing else, and the
results are gathered once at the end.

On a CUDA device without ``comm`` the transitions replay captured CUDA
graphs (:class:`.nuts.Transitions`), which give what the direct
transitions (``graphs=False``) give, bit for bit; the adaptation between
transitions and the step-size searches at window boundaries run directly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .adapt import (
    build_segments,
    da_init,
    da_update,
    find_reasonable_step_size,
    welford_init,
    welford_update,
    welford_update_batch,
    welford_variance,
)
from .draws import BlockDraws, as_draws
from .integrators import IntegratorState, mass_chol, value_and_grad
from .nuts import Transitions


class MCMCResult(NamedTuple):
    samples: torch.Tensor        # (num_chains, num_samples, d)
    accept_prob: torch.Tensor    # (num_chains,) mean sampling-phase acceptance
    num_divergent: torch.Tensor  # (num_chains,)
    step_size: torch.Tensor      # (num_chains,) adapted step size
    inv_mass: torch.Tensor       # (num_chains, d) diag metric, (num_chains, d, d) dense
    tree_depth: torch.Tensor | None = None   # (num_chains,) mean sampling-phase depth

    @property
    def inv_mass_diag(self):
        """Deprecated alias kept from the JAX package: the field holds full
        (d, d) matrices in dense mode."""
        return self.inv_mass


def _shared(x: torch.Tensor, C: int) -> torch.Tensor:
    """One pooled value as every chain's (C,)-leading view."""
    return x.expand((C,) + tuple(x.shape))


def _reasonable_step(vg, state, inv_mass, chol, draws, pooled, gather, comm,
                     init_step=1.0):
    """Per-chain reasonable step sizes; pooled: the median over every
    chain, which one outlying start cannot drag (``torch.quantile``
    averages the two middle values of an even count, as ``jnp.median``
    does; ``torch.median`` would take the lower one)."""
    steps = find_reasonable_step_size(vg, state.z, state.logp, state.grad, inv_mass,
                                      draws, init_step=init_step, chol=chol, comm=comm)
    return torch.quantile(gather(steps), 0.5) if pooled else steps


def run_nuts(logdensity_fn: Callable, init_params: torch.Tensor, gen,
             num_warmup: int = 1000, num_samples: int = 1000,
             max_depth: int = 10, target_accept: float = 0.8,
             pooled_adaptation: bool = False,
             dense_mass: bool = False, comm=None, segment: int | None = None,
             graphs: bool | None = None) -> MCMCResult:
    """Sample with NUTS.  ``logdensity_fn``: batched, (C, d) -> (C,);
    ``init_params``: (num_chains, d); ``gen``: a ``torch.Generator`` (or a
    draw source).  Returns all chains.

    ``target_accept`` default 0.8; the reference drivers use Stan's
    adapt_delta=0.9.  ``pooled_adaptation=True`` shares the step size and
    the metric across all chains (means over chains drive dual averaging;
    Welford merges every chain's positions).  ``dense_mass=True`` adapts a
    full (d, d) covariance metric (Stan's ``dense_e``); ``inv_mass`` in the
    result then holds (num_chains, d, d) matrices.

    ``comm`` (a chain-axis :class:`..parallel.comm.Comm`): ``init_params``
    and ``logdensity_fn`` are this rank's block of ``comm.world`` equal
    blocks of chains, ``gen`` starts alike on every rank, and every rank
    returns the result of all chains (see the module docstring).

    ``graphs`` (default: on a CUDA device without ``comm``) replays each
    transition's pieces as CUDA graphs, drawing from ``gen`` (then a
    ``torch.Generator`` on the chains' device); ``graphs=False`` runs them
    directly, the reference the graphs are held to.  ``segment``: the
    leaves between two host reads (:class:`.nuts.Transitions`); every
    value gives the same draws.
    """
    draws = as_draws(gen)
    if comm is None:
        gather = lambda x: x                                  # noqa: E731
    else:
        draws = BlockDraws(draws, comm.lo, comm.world * comm.n_loc)
        gather = lambda x: comm.gather(x, "chains")           # noqa: E731
    segments = build_segments(num_warmup)
    vg = value_and_grad(logdensity_fn)
    C, d = init_params.shape
    dtype, dev = init_params.dtype, init_params.device
    pooled = pooled_adaptation

    logp0, grad0 = vg(init_params)
    state = IntegratorState(init_params, torch.zeros_like(init_params), logp0, grad0)
    metric = (torch.eye(d, dtype=dtype, device=dev) if dense_mass
              else torch.ones(d, dtype=dtype, device=dev))
    inv_mass = _shared(metric, C)
    chol = mass_chol(inv_mass)
    da = da_init(_reasonable_step(vg, state, inv_mass, chol, draws, pooled, gather, comm))
    wbatch = () if pooled else (C,)
    wf = welford_init(d, dtype, dense=dense_mass, batch=wbatch, device=dev)
    kernel = Transitions(vg, draws, max_depth, segment, graphs, comm)

    # one metric and factor per segment; at window boundaries swap in the
    # new metric, re-search a reasonable step under it, restart dual
    # averaging and Welford (Stan semantics, adapt.build_segments)
    for length, slow, boundary in segments:
        for _ in range(length):
            state, info = kernel(state, torch.exp(da.log_step), inv_mass, chol)
            acc = gather(info.accept_prob).mean() if pooled else info.accept_prob
            da = da_update(da, acc, target=target_accept)
            if slow:
                wf = (welford_update_batch(wf, gather(state.z)) if pooled
                      else welford_update(wf, state.z))
        if boundary:
            metric = welford_variance(wf)
            inv_mass = _shared(metric, C) if pooled else metric
            chol = mass_chol(inv_mass)
            da = da_init(_reasonable_step(vg, state, inv_mass, chol, draws, pooled, gather,
                                          comm, init_step=torch.exp(da.log_step)))
            wf = welford_init(d, dtype, dense=dense_mass, batch=wbatch, device=dev)

    step_size = torch.exp(da.log_step_avg)
    zs, accepts, divs, depths = [], [], [], []
    for _ in range(num_samples):
        state, info = kernel(state, step_size, inv_mass, chol)
        zs.append(state.z)
        accepts.append(info.accept_prob)
        divs.append(info.diverging)
        depths.append(info.depth)
    mean = lambda xs: torch.stack(xs, dim=1).float().mean(dim=1)  # noqa: E731
    res = MCMCResult(torch.stack(zs, dim=1), mean(accepts),
                     torch.stack(divs, dim=1).sum(dim=1),
                     step_size.expand(C).clone(), inv_mass.contiguous(), mean(depths))
    return res if comm is None else MCMCResult(*(gather(x) for x in res))
