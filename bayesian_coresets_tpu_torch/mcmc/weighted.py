"""Weighted-likelihood posteriors and the user-facing MCMC entry point.

Port of ``bayesian_coresets_tpu/mcmc/weighted.py``.  The reference gets
weighted-likelihood MCMC by hand-editing Stan-generated C++
(examples/common/mcmc.py:9-30); here the weighted log-joint
``sum_i w_i ll_i(theta) + log pi(theta)`` is a batched function of theta,
and any model module with ``log_joint`` works unmodified.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..models.laplace import laplace_approx, sample_laplace
from .sample import MCMCResult, run_nuts


def weighted_logdensity(model, z: torch.Tensor, wts: torch.Tensor,
                        ref: torch.Tensor | None = None) -> Callable:
    """Build theta (C, d) -> (C,) log p(theta) + sum_i w_i ll(z_i, theta) (+ const).

    ``model`` is any module or namespace exposing ``log_joint(z, th, wts)``
    batched over rows of th (e.g. ``models.logistic``).

    With ``ref`` (and a model exposing ``log_likelihood``/``log_prior``) the
    density is taken relative to the reference point,
    ``sum_i w_i (ll_i(theta) - ll_i(ref)) + log pi(theta)``: the same
    function up to a constant, but f32-clean for concentrated weighted
    posteriors, whose absolute weighted sum reaches ~1e5 where f32 noise
    poisons NUTS energy differences.  A model with ``log_likelihood_diff``
    gives each per-datum difference stably.
    """
    if ref is not None and hasattr(model, "log_likelihood_diff") \
            and hasattr(model, "log_prior"):
        def logdensity(theta):
            return wts @ model.log_likelihood_diff(z, theta, ref) + model.log_prior(theta)
        return logdensity

    if ref is not None and hasattr(model, "log_likelihood") and hasattr(model, "log_prior"):
        ll_ref = model.log_likelihood(z, ref[None, :])               # (n, 1)

        def logdensity(theta):
            return wts @ (model.log_likelihood(z, theta) - ll_ref) + model.log_prior(theta)
        return logdensity

    def logdensity(theta):
        return model.log_joint(z, theta, wts)
    return logdensity


def fit_laplace(model, z: torch.Tensor, wts: torch.Tensor, d: int):
    """Laplace approximation of the weighted posterior, or None if the model
    lacks gradient/Hessian functions."""
    grad_fn = getattr(model, "grad_th_log_joint", None)
    hess_fn = getattr(model, "hess_th_log_joint", None)
    if grad_fn is None or hess_fn is None:
        return None
    return laplace_approx(z, wts, torch.zeros(d, dtype=z.dtype, device=z.device),
                          grad_fn=grad_fn, hess_fn=hess_fn)


def laplace_init(model, z: torch.Tensor, wts: torch.Tensor, num_chains: int,
                 gen: torch.Generator, d: int) -> torch.Tensor:
    """Overdispersed chain inits (num_chains, d) from the Laplace fit.

    Concentrated weighted posteriors sit tens of posterior sds from zero; a
    chain that has not finished that transit when the first adaptation
    window closes locks in a collapsed metric.  Starting from the Laplace
    fit puts every chain in the typical set and keeps the inits overdispersed
    for split R-hat.  Zeros when the model lacks Hessians.
    """
    lap = fit_laplace(model, z, wts, d)
    if lap is None:
        return torch.zeros((num_chains, d), dtype=z.dtype, device=z.device)
    return sample_laplace(gen, lap, num_chains)


def _synchronize(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run(model, z: torch.Tensor, wts: torch.Tensor, n_samples: int, gen: torch.Generator,
        d: int | None = None, num_chains: int = 1, max_depth: int = 15,
        target_accept: float = 0.9, init: torch.Tensor | None = None,
        pooled_adaptation: bool = False, num_warmup: int | None = None,
        precondition: bool = True, f64_logdensity: bool = False,
        dense_mass: bool = False, mesh=None, graphs: bool | None = None):
    """Weighted-posterior NUTS with the reference driver's conventions.

    ``n_samples`` kept draws per chain after ``num_warmup`` warmup steps
    (default ``n_samples``: the reference's iter=2N with half burn-in);
    ``target_accept`` defaults to Stan's adapt_delta=0.9 and ``max_depth``
    to the reference's max_treedepth=15 (mcmc.py:58).  When splitting a
    total draw budget across chains, pass ``num_warmup`` explicitly: warmup
    must not shrink with the chain count.

    ``precondition=True`` (for a model with grad/hess of the log-joint)
    samples the exact reparameterization theta = mu + USig u around the
    Laplace fit, so NUTS runs on a ~N(0, I) geometry; results come back in
    theta space, while ``step_size``/``inv_mass`` describe u space.  Pass
    ``init`` (theta-space chain inits) to turn it off.

    ``f64_logdensity=True`` evaluates only the log-density and its gradient
    in float64 (a real f64 island on the H100) and rounds the small relative
    value back to float32; the integrator, adaptation and states stay f32.

    ``dense_mass=True`` adapts a full covariance metric (Stan's ``dense_e``).

    ``mesh`` (``parallel.make_mesh``; the JAX package's weighted.py:101-110,
    209-229) splits the chains over the mesh's chain axis, each rank
    sampling its block (``num_chains`` a multiple of the axis): every rank
    makes all the chain inits from ``gen``, which must start alike on every
    rank, and returns every chain's draws; the sampled distribution is
    unchanged (``parallel/mcmc.py``).
    ``graphs``: how the transitions run (``sample.run_nuts``; by default as
    replayed CUDA graphs on a card, ``graphs=False`` for the direct
    reference); sharded chains run directly.
    ``gen`` is a ``torch.Generator`` on the data's device.
    Returns (samples (num_chains * n_samples, d), wall seconds, MCMCResult).
    """
    if mesh is not None:
        from ..parallel.mcmc import run_nuts_sharded

        if graphs:
            raise ValueError("sharded chains run their transitions directly (graphs=True "
                             "needs mesh=None)")

        def sampler(logdensity_fn, init_params, gen, **kw):
            return run_nuts_sharded(logdensity_fn, init_params, gen, mesh, **kw)
    else:
        sampler = run_nuts
    if d is None:
        d = z.shape[1]
    kw = dict(num_warmup=num_warmup or n_samples, num_samples=n_samples,
              max_depth=max_depth, target_accept=target_accept,
              pooled_adaptation=pooled_adaptation, dense_mass=dense_mass)
    if mesh is None:
        kw["graphs"] = graphs
    lap = fit_laplace(model, z, wts, d) if (precondition and init is None) else None
    if lap is not None:
        mu, A = lap.mu, lap.USig                      # Sig = A @ A.T
        wide = torch.float64 if f64_logdensity else z.dtype
        zl, wl, mul, Al = (t.to(wide) for t in (z, wts, mu, A))
        logdensity_rel = weighted_logdensity(model, zl, wl, ref=mul)

        def logdensity_u(u):
            return logdensity_rel(mul + u.to(wide) @ Al.T).to(torch.float32)

        init_u = torch.randn((num_chains, d), generator=gen, dtype=torch.float32,
                             device=gen.device).to(z.device)
        _synchronize(z)
        t0 = time.perf_counter()
        res: MCMCResult = sampler(logdensity_u, init_u, gen, **kw)
        _synchronize(res.samples)
        t = time.perf_counter() - t0
        theta = res.samples @ A.T + mu                # (chains, draws, d)
        res = res._replace(samples=theta)
        return theta.reshape(-1, d), t, res
    logdensity = weighted_logdensity(model, z, wts)
    if init is None:
        init = laplace_init(model, z, wts, num_chains, gen, d)
    _synchronize(z)
    t0 = time.perf_counter()
    res = sampler(logdensity, init, gen, **kw)
    _synchronize(res.samples)
    t = time.perf_counter() - t0
    return res.samples.reshape(-1, d), t, res
