"""Warmup adaptation: dual-averaging step size and windowed mass matrix.

Port of ``bayesian_coresets_tpu/mcmc/adapt.py``: Stan's windowed schedule
(an initial fast window for the step size only, doubling slow windows that
accumulate Welford statistics for the metric, a terminal fast window).  The
schedule is built on the host as in the JAX package.  Every state here may
carry a leading chain dimension: per-chain adaptation keeps one dual
averaging and one Welford state per chain, pooled adaptation one in all.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .draws import as_draws
from .integrators import IntegratorState, kinetic, leapfrog, per_chain, sample_momentum

_LOG10 = 2.302585092994046
_LOG_HALF = float(np.float32(np.log(0.5)))


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def da_init(step_size: torch.Tensor) -> DualAveragingState:
    log_step = torch.log(step_size)
    # the running average starts AT the current step, so a zero-length
    # window after a boundary reset keeps a sane step size
    zero = torch.zeros_like(log_step)
    return DualAveragingState(log_step, log_step, zero, _LOG10 + log_step, zero)


def da_update(state: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_step = state.mu - torch.sqrt(count) / gamma * h_bar
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_bar, state.mu, count)


class WelfordState(NamedTuple):
    count: torch.Tensor   # batch shape B
    mean: torch.Tensor    # B + (d,)
    m2: torch.Tensor      # B + (d,) running variance sums, or B + (d, d) scatter


def welford_init(d: int, dtype=torch.float32, dense: bool = False, batch=(),
                 device=None) -> WelfordState:
    """``dense=True`` accumulates the full scatter matrix (Stan's
    ``dense_e``); ``batch`` is a leading shape, e.g. ``(C,)`` for one state
    per chain."""
    batch = tuple(batch)
    m2 = torch.zeros(batch + ((d, d) if dense else (d,)), dtype=dtype, device=device)
    return WelfordState(torch.zeros(batch, dtype=dtype, device=device),
                        torch.zeros(batch + (d,), dtype=dtype, device=device), m2)


def _is_dense(state: WelfordState) -> bool:
    return state.m2.dim() == state.mean.dim() + 1


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """Add one sample x (B + (d,)) to each state."""
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    if _is_dense(state):
        m2 = state.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_update_batch(state: WelfordState, xs: torch.Tensor) -> WelfordState:
    """Merge a batch xs (C, d) into one unbatched state in one step (Chan
    et al. parallel update): pooled cross-chain adaptation, where every
    warmup step contributes one position per chain.  The dense scatter is a
    full-f32 product (TF32 off): it becomes the inverse mass."""
    c = xs.shape[0]
    batch_mean = torch.mean(xs, dim=0)
    centered = xs - batch_mean
    count = state.count + c
    delta = batch_mean - state.mean
    mean = state.mean + delta * (c / count)
    if _is_dense(state):
        batch_m2 = centered.T @ centered
        m2 = state.m2 + batch_m2 + torch.outer(delta, delta) * (state.count * c / count)
    else:
        batch_m2 = torch.sum(centered**2, dim=0)
        m2 = state.m2 + batch_m2 + delta**2 * (state.count * c / count)
    return WelfordState(count, mean, m2)


def welford_variance(state: WelfordState) -> torch.Tensor:
    """Regularized variance or covariance estimate (Stan's shrinkage toward
    unit): diagonal -> B + (d,); dense -> B + (d, d), symmetrized, with an
    identity ridge keeping it positive definite through short windows."""
    dense = _is_dense(state)
    n = torch.clamp(state.count, min=1.0)
    n = n.reshape(n.shape + (1,) * (state.m2.dim() - n.dim()))
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    shrink = n / (n + 5.0)
    ridge = 1e-3 * (5.0 / (n + 5.0))
    if dense:
        eye = torch.eye(state.m2.shape[-1], dtype=state.m2.dtype, device=state.m2.device)
        cov = shrink * var + ridge * eye
        return 0.5 * (cov + cov.transpose(-1, -2))
    return shrink * var + ridge


def build_schedule(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                   base_window: int = 25):
    """Boolean masks over warmup iterations: (in_slow_window, window_end).

    Mirrors Stan's windowed adaptation; degenerates gracefully for short
    warmups (mass adaptation disabled below ~20 iterations).
    """
    in_slow = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    if num_warmup < init_buffer + term_buffer + base_window:
        # too short for windows: step-size-only adaptation
        return in_slow, window_end
    start = init_buffer
    size = base_window
    while start < num_warmup - term_buffer:
        end = min(start + size, num_warmup - term_buffer)
        # if the next window would not fit, extend this one to the boundary
        if end + size > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        in_slow[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2
    return in_slow, window_end


def build_segments(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                   base_window: int = 25):
    """Static warmup segmentation: tuple of (length, slow, boundary).

    ``slow``: accumulate Welford mass statistics during the segment;
    ``boundary``: at segment end, swap in the new mass matrix, re-search a
    reasonable step size under it, and restart dual averaging (Stan's window
    semantics).
    """
    in_slow, window_end = build_schedule(num_warmup, init_buffer, term_buffer,
                                         base_window)
    segments = []
    start = 0
    for i in range(num_warmup):
        boundary = bool(window_end[i])
        last = i == num_warmup - 1
        change = (not last) and (bool(in_slow[i + 1]) != bool(in_slow[i]))
        if boundary or last or change:
            segments.append((i - start + 1, bool(in_slow[i]), boundary))
            start = i + 1
    return tuple(s for s in segments if s[0] > 0)


def find_reasonable_step_size(value_and_grad_fn, z, logp, grad, inv_mass, draws,
                              init_step=1.0, target=0.8, chol=None, comm=None) -> torch.Tensor:
    """Double or halve each chain's step until its one-step acceptance
    crosses 0.5 (Hoffman & Gelman Algorithm 4), at most 60 times.

    All chains step together; a chain that has crossed is frozen, and the
    loop ends when every chain has (one host read per round).  A chain that
    never crosses within 60 rounds keeps ``init_step``: the runaway 2^±60
    step of a pathological state (e.g. a non-finite cached gradient) would
    freeze or explode the sampler.  ``init_step``: scalar or (C,);
    ``draws``: a draw source or a ``torch.Generator``; ``comm``: the chain
    axis's exchanges when the chains are this rank's block (the loop then
    ends when every rank's chains have crossed).
    """
    r0 = sample_momentum(as_draws(draws), inv_mass, z.shape, z.dtype, chol=chol)
    s0 = IntegratorState(z, r0, logp, grad)
    joint0 = logp - kinetic(r0, inv_mass)

    def above_half(step):
        s1 = leapfrog(value_and_grad_fn, s0, step, inv_mass)
        out = s1.logp - kinetic(s1.r, inv_mass) - joint0
        return torch.where(torch.isnan(out), float("-inf"), out) > _LOG_HALF

    init = per_chain(init_step, logp)
    grow = above_half(init)
    factor = torch.where(grow, 2.0, 0.5).to(init.dtype)
    step = init.clone()
    iters = torch.zeros_like(step, dtype=torch.int32)
    while True:
        moving = (above_half(step) == grow) & (iters < 60)
        if not (bool(moving.any()) if comm is None else comm.any(moving)):
            break
        step = torch.where(moving, step * factor, step)
        iters = iters + moving.to(torch.int32)
    return torch.where(iters < 60, step, init)
