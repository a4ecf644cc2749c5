"""Leapfrog integrator and metric operations for HMC/NUTS, over C chains.

Port of ``bayesian_coresets_tpu/mcmc/integrators.py``.  JAX writes the
kernels for one chain and vmaps them; here chains are a leading batch
dimension, and every chain carries its own metric:

- ``(C, d)``    diagonal metric, the estimated posterior variances (Stan's
  ``diag_e``);
- ``(C, d, d)`` dense metric, the regularized posterior covariance
  Sigma = M^{-1} (Stan's ``dense_e``).  Momentum is r = L^{-T} u with
  Sigma = L L^T, so cov(r) = Sigma^{-1} = M.

Float32 matrix products run in full float32 (TF32 is off,
``utils/config.py``), the counterpart of the JAX package's pinned
``Precision.HIGHEST``: NUTS energy differences cannot afford TF32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import config  # noqa: F401  (switches TF32 off)


class IntegratorState(NamedTuple):
    z: torch.Tensor      # positions (C, d)
    r: torch.Tensor      # momenta (C, d)
    logp: torch.Tensor   # log-density at z (C,)
    grad: torch.Tensor   # d logp / dz (C, d)


def value_and_grad(logdensity_fn: Callable) -> Callable:
    """theta (C, d) -> (logp (C,), grad (C, d)) for a batched log-density
    (C, d) -> (C,).  The gradient is autograd's of the sum over chains:
    chains are independent, so row c is chain c's own gradient.  Any model
    works; there is no closed form."""
    def vg(z: torch.Tensor):
        with torch.enable_grad():
            x = z.detach().requires_grad_(True)
            lp = logdensity_fn(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g
    return vg


def mass_mul(inv_mass: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """M^{-1} r per chain (the metric velocity); ``r`` is (C, d) or a stack
    (C, K, d).  The dense inverse mass is symmetric, so ``r @ inv_mass``."""
    if inv_mass.dim() == 2:
        return r * (inv_mass if r.dim() == 2 else inv_mass[:, None, :])
    if r.dim() == 2:
        return torch.matmul(r[:, None, :], inv_mass)[:, 0]
    return torch.matmul(r, inv_mass)


def mass_chol(inv_mass: torch.Tensor) -> torch.Tensor:
    """Factor used by :func:`sample_momentum`: the square root of a diagonal
    metric, the lower Cholesky factor L (Sigma = L L^T) of a dense one.  The
    metric is constant within a warmup segment, so callers factor once per
    segment."""
    if inv_mass.dim() == 2:
        return torch.sqrt(inv_mass)
    return torch.linalg.cholesky(inv_mass)


def sample_momentum(draws, inv_mass: torch.Tensor, shape, dtype,
                    chol: torch.Tensor | None = None) -> torch.Tensor:
    """Draw r ~ N(0, M) per chain (M = inv_mass^{-1}); ``chol`` is an
    optional precomputed :func:`mass_chol`."""
    u = draws.momentum(shape, dtype, inv_mass.device)
    if chol is None:
        chol = mass_chol(inv_mass)
    if inv_mass.dim() == 2:
        return u / chol
    # Sigma = L L^T  =>  M = L^{-T} L^{-1};  r = L^{-T} u has cov M
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), u[..., None],
                                         upper=True)[..., 0]


def where_state(mask: torch.Tensor, a: IntegratorState, b: IntegratorState) -> IntegratorState:
    """Per chain: ``a`` where ``mask`` (C,), else ``b``."""
    m = mask[:, None]
    return IntegratorState(torch.where(m, a.z, b.z), torch.where(m, a.r, b.r),
                           torch.where(mask, a.logp, b.logp), torch.where(m, a.grad, b.grad))


def per_chain(x, ref: torch.Tensor) -> torch.Tensor:
    """A scalar or (C,) value as a (C,) tensor in ``ref``'s dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device).expand(ref.shape[0])


def leapfrog(value_and_grad_fn: Callable, state: IntegratorState, step_size,
             inv_mass: torch.Tensor) -> IntegratorState:
    """One leapfrog step for every chain; ``step_size`` is a scalar or (C,),
    and may be negative (backward in time)."""
    eps = per_chain(step_size, state.logp)[:, None]
    r = state.r + 0.5 * eps * state.grad
    z = state.z + eps * mass_mul(inv_mass, r)
    logp, grad = value_and_grad_fn(z)
    r = r + 0.5 * eps * grad
    return IntegratorState(z, r, logp, grad)


def kinetic(r: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(r * mass_mul(inv_mass, r), dim=-1)
