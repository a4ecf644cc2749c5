"""Fixed-trajectory HMC kernel (companion to NUTS), over C chains.

Port of ``bayesian_coresets_tpu/mcmc/hmc.py``.  With jittered steps each
chain draws its own trajectory length; all chains step together for the
longest one, and a chain whose trajectory has ended is frozen by
``torch.where`` (one host read per transition, for that length).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .draws import as_draws
from .integrators import IntegratorState, kinetic, leapfrog, sample_momentum, where_state


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor   # (C,)
    accepted: torch.Tensor      # (C,) bool


def hmc_kernel(value_and_grad_fn: Callable, draws, state: IntegratorState,
               step_size, inv_mass: torch.Tensor, num_steps: int = 32,
               jitter_steps: bool = True, inv_mass_chol: torch.Tensor | None = None):
    """One Metropolis-corrected HMC transition with ``num_steps`` leapfrogs.

    ``jitter_steps`` draws each chain's trajectory length uniformly in
    [1, num_steps] every transition, the standard guard against periodic
    trajectories resonating with the target.  ``draws``: a draw source or a
    ``torch.Generator``; ``inv_mass_chol``: optional ``mass_chol(inv_mass)``.
    """
    draws = as_draws(draws)
    C = state.z.shape[0]
    dev = state.z.device
    r0 = sample_momentum(draws, inv_mass, state.z.shape, state.z.dtype, chol=inv_mass_chol)
    s0 = IntegratorState(state.z, r0, state.logp, state.grad)
    joint0 = s0.logp - kinetic(r0, inv_mass)

    if jitter_steps:
        n_steps = draws.num_steps(C, num_steps, dev)
        longest = int(n_steps.max())
    else:
        n_steps, longest = None, num_steps
    s1 = s0
    for k in range(longest):
        new = leapfrog(value_and_grad_fn, s1, step_size, inv_mass)
        s1 = new if n_steps is None else where_state(k < n_steps, new, s1)
    joint1 = s1.logp - kinetic(s1.r, inv_mass)
    log_accept = torch.where(torch.isnan(joint1), float("-inf"), joint1 - joint0)
    accept_prob = torch.clamp(torch.exp(torch.clamp(log_accept, max=0.0)), max=1.0)
    accepted = draws.accept_uniform(C, dev) < accept_prob
    new = where_state(accepted, s1, s0)
    return (IntegratorState(new.z, torch.zeros_like(r0), new.logp, new.grad),
            HMCInfo(accept_prob, accepted))
