"""Laplace approximation via fixed-iteration damped Newton.

Port of ``bayesian_coresets_tpu/models/laplace.py:33-85``.  For the models
here (logistic regression with an N(0, I) prior) the weighted log-joint is
strictly concave with Hessian ⪯ -I, so damped Newton converges
quadratically; a fixed iteration count (default 25) replaces the
reference's scipy convergence test.  The diagonal mode is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LaplaceResult(NamedTuple):
    mu: torch.Tensor       # mode of the weighted log-joint (d,)
    USig: torch.Tensor     # Sig = USig @ USig.T (upper triangular)
    LSigInv: torch.Tensor  # SigInv = LSigInv @ LSigInv.T (lower triangular)


def laplace_approx(
    z: torch.Tensor,
    wts: torch.Tensor,
    mu0: torch.Tensor,
    grad_fn: Callable,   # (z, th(1,d), wts) -> (1, d)
    hess_fn: Callable,   # (z, th(1,d), wts) -> (1, d, d)
    num_iters: int = 25,
    damping: float = 1e-7,
) -> LaplaceResult:
    """Fit a Gaussian N(mu, Sig) at the mode of the weighted log-joint.

    Sig = inv(-H) = L^{-T} L^{-1} with L = chol(-H), so USig = L^{-T} and
    samples are mu + eps @ USig.T (the JAX package's exact form).
    """
    d = mu0.shape[0]
    eye = torch.eye(d, dtype=mu0.dtype, device=mu0.device)
    th = mu0
    for _ in range(num_iters):
        g = grad_fn(z, th[None, :], wts)[0]
        h = hess_fn(z, th[None, :], wts)[0]
        L = torch.linalg.cholesky(-h + damping * eye)
        th = th + torch.cholesky_solve(g[:, None], L)[:, 0]
    h = hess_fn(z, th[None, :], wts)[0]
    LSigInv = torch.linalg.cholesky(-h)
    USig = torch.linalg.solve_triangular(LSigInv, eye, upper=False).T
    return LaplaceResult(th, USig, LSigInv)


def sample_laplace(gen: torch.Generator, result: LaplaceResult,
                   n_samples: int) -> torch.Tensor:
    """Draw n_samples from the fitted Gaussian.  The normal draws come from
    ``gen`` on its own device and move to the result's device."""
    d = result.mu.shape[0]
    eps = torch.randn((n_samples, d), generator=gen, dtype=result.mu.dtype,
                      device=gen.device).to(result.mu.device)
    return result.mu + eps @ result.USig.T
