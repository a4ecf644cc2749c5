"""Conjugate multivariate-Gaussian model.

Port of ``bayesian_coresets_tpu/models/gaussian.py`` (reference
``examples/common/model_gaussian.py:4-30``): batched log-likelihood and
data-gradient, Gaussian-vs-Gaussian KL (on the device, and in host f64),
the closed-form weighted posterior, and the joint diagonalization that
makes SparseVI's and BatchPSVI's per-step posterior refits free of any
factorization.

Model: x_i ~ N(theta, Sig), theta ~ N(mu0, Sig0).  Samplers take a
``torch.Generator`` where the JAX package takes a key; their normal draws
are made on the generator's device and moved to the data's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_LOG2PI = 1.8378770664093453


def _atleast_2d(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() >= 2 else x.reshape(1, -1)


def _randn(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=gen.device).to(like.device)


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``a`` (or of each matrix of a batch); where
    the factorization fails, NaN on and below the diagonal and 0 above, as
    JAX's ``cholesky`` returns it.  ``torch.linalg.cholesky`` reads the
    error code back to raise, which synchronizes a CUDA device and cannot
    run inside a captured CUDA graph; this reads nothing.  The factor keeps
    ``cholesky``'s column-major layout (the mask of the strictly upper
    triangle is made column-major too)."""
    L, info = torch.linalg.cholesky_ex(a)
    d = a.shape[-1]
    above = torch.ones((d, d), dtype=torch.bool, device=a.device).tril(-1).mT
    return torch.where((info == 0)[..., None, None] | above, L, torch.nan)


def log_likelihood(x: torch.Tensor, th: torch.Tensor, Siginv: torch.Tensor,
                   logdetSig) -> torch.Tensor:
    """(n, S) log-densities for x (n, d) and th (S, d) (model_gaussian.py:4-11)."""
    x = _atleast_2d(x)
    th = _atleast_2d(th)
    d = x.shape[1]
    xS = x @ Siginv                                  # (n, d)
    xSx = torch.sum(xS * x, dim=1)                   # (n,)
    thS = th @ Siginv                                # (S, d)
    thSth = torch.sum(thS * th, dim=1)               # (S,)
    quad = xSx[:, None] + thSth[None, :] - 2.0 * (xS @ th.T)
    return -0.5 * d * _LOG2PI - 0.5 * logdetSig - 0.5 * quad


def grad_x_log_likelihood(x: torch.Tensor, th: torch.Tensor,
                          Siginv: torch.Tensor) -> torch.Tensor:
    """(n, S, d) gradient with respect to the datapoint (model_gaussian.py:12-15)."""
    x = _atleast_2d(x)
    th = _atleast_2d(th)
    return (th @ Siginv)[None, :, :] - (x @ Siginv)[:, None, :]


def kl_divergence(mu0: torch.Tensor, Sig0: torch.Tensor, mu1: torch.Tensor,
                  Sig1inv: torch.Tensor) -> torch.Tensor:
    """KL( N(mu0, Sig0) || N(mu1, Sig1) ), Sig1 given by its inverse
    (model_gaussian.py:17-21)."""
    d = mu0.shape[0]
    t1 = torch.trace(Sig1inv @ Sig0)
    dmu = mu1 - mu0
    t2 = dmu @ (Sig1inv @ dmu)
    t3 = -torch.linalg.slogdet(Sig1inv)[1] - torch.linalg.slogdet(Sig0)[1]
    return 0.5 * (t1 + t2 + t3 - d)


def kl_divergence_np(mu0, Sig0, mu1, Sig1inv) -> float:
    """The same KL in f64 NumPy on the host, for quality metrics: on
    ill-conditioned posteriors the trace and log-determinant terms cancel
    far below their own size, which f32 cannot resolve."""
    mu0, Sig0, mu1, Sig1inv = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                                          np.float64) for a in (mu0, Sig0, mu1, Sig1inv))
    d = mu0.shape[0]
    t1 = np.trace(Sig1inv @ Sig0)
    dmu = mu1 - mu0
    t2 = dmu @ (Sig1inv @ dmu)
    t3 = -np.linalg.slogdet(Sig1inv)[1] - np.linalg.slogdet(Sig0)[1]
    return float(0.5 * (t1 + t2 + t3 - d))


class WeightedPost(NamedTuple):
    mu: torch.Tensor       # posterior mean (d,)
    USig: torch.Tensor     # Sig = USig @ USig.T, upper triangular
    LSigInv: torch.Tensor  # SigInv = LSigInv @ LSigInv.T, lower triangular


def _weighted_rhs(th0, Sig0inv, Siginv, x, w):
    if w.shape[0] > 0:
        wx = torch.sum(w[:, None] * _atleast_2d(x), dim=0)
    else:
        wx = torch.zeros_like(th0)
    return Sig0inv @ th0 + Siginv @ wx


def weighted_post(th0, Sig0inv, Siginv, x, w) -> WeightedPost:
    """Closed-form weighted posterior (model_gaussian.py:23-30): precision
    Sig0inv + (sum w) Siginv, mean solving Prec mu = Sig0inv th0 +
    Siginv sum_i w_i x_i.  Zero total weight gives the prior."""
    d = th0.shape[0]
    prec = Sig0inv + torch.sum(w) * Siginv
    LSigInv = cholesky(prec)
    eye = torch.eye(d, dtype=LSigInv.dtype, device=LSigInv.device)
    USig = torch.linalg.solve_triangular(LSigInv, eye, upper=False).T
    mu = USig @ (USig.T @ _weighted_rhs(th0, Sig0inv, Siginv, x, w))
    return WeightedPost(mu, USig, LSigInv)


def sample_weighted_post(gen: torch.Generator, th0, Sig0inv, Siginv, x, w,
                         n_samples: int) -> torch.Tensor:
    """n_samples thetas from the closed-form weighted posterior: one
    Cholesky Prec = L L^T, the mean by two triangular solves, and samples
    mu + L^{-T} eps (no dense inverse)."""
    d = th0.shape[0]
    L = cholesky(Sig0inv + torch.sum(w) * Siginv)
    rhs = _weighted_rhs(th0, Sig0inv, Siginv, x, w)
    y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
    mu = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    eps = _randn(gen, (n_samples, d), L)
    return mu + torch.linalg.solve_triangular(L.T, eps.T, upper=True).T


class PosteriorBasis(NamedTuple):
    """Joint diagonalization of (Sig0inv, Siginv) for O(d^2) refits.

    The weighted precision is the one-parameter family
    prec(s) = Sig0inv + s Siginv, s = sum_i w_i.  With L0 = chol(Sig0inv)
    and A = L0^{-1} Siginv L0^{-T} = V diag(lam) V^T computed once,
    prec(s) = U (I + s lam) U^T for the fixed U = L0 V, so every refit is a
    diagonal scaling and matmuls.
    """

    Uinv: torch.Tensor    # (d, d) = V^T L0^{-1}
    UinvT: torch.Tensor   # (d, d) = Uinv.T
    lam: torch.Tensor     # (d,) eigenvalues of L0^{-1} Siginv L0^{-T}
    r0: torch.Tensor      # (d,) = Sig0inv @ th0
    Siginv: torch.Tensor  # (d, d) likelihood precision


def posterior_basis(th0, Sig0inv, Siginv) -> PosteriorBasis:
    """One-time O(d^3) setup for :func:`weighted_post_basis` and
    :func:`sample_weighted_post_basis`.

    Where A has repeated eigenvalues (e.g. Sig0inv = Siginv = I, where
    A = I) its eigenbasis is not unique, and ``torch.linalg.eigh`` may
    return another one than ``jnp.linalg.eigh``; the posterior mean and
    covariance, and the Gram of the exact tangent features, do not depend
    on the choice.
    """
    d = th0.shape[0]
    eye = torch.eye(d, dtype=Sig0inv.dtype, device=Sig0inv.device)
    L0 = torch.linalg.cholesky(Sig0inv)
    L0inv = torch.linalg.solve_triangular(L0, eye, upper=False)
    A = L0inv @ Siginv @ L0inv.T
    lam, V = torch.linalg.eigh(0.5 * (A + A.T))
    Uinv = V.T @ L0inv
    return PosteriorBasis(Uinv, Uinv.T.contiguous(), lam, Sig0inv @ th0, Siginv)


def _basis_mu_scale(basis: PosteriorBasis, x, w):
    w = w.reshape(-1)
    dinv = 1.0 / (1.0 + torch.sum(w) * basis.lam)        # spectrum of prec(s)^{-1}
    if w.shape[0] > 0:
        wx = torch.sum(w[:, None] * _atleast_2d(x), dim=0)
    else:
        wx = torch.zeros_like(basis.r0)
    rhs = basis.r0 + basis.Siginv @ wx
    mu = basis.UinvT @ (dinv * (basis.Uinv @ rhs))
    return mu, torch.sqrt(dinv)


def weighted_post_basis(basis: PosteriorBasis, x, w):
    """Fast ``weighted_post``: ``(mu, F)`` with Sig = F F^T, F a general
    (non-triangular) factor, equivalent wherever only the Gram matters."""
    mu, scale = _basis_mu_scale(basis, x, w)
    return mu, basis.UinvT * scale[None, :]


def sample_weighted_post_basis(gen: torch.Generator, basis: PosteriorBasis, x, w,
                               n_samples: int) -> torch.Tensor:
    """Fast ``sample_weighted_post``: theta = mu + (eps * scale) @ Uinv,
    whose covariance is U^{-T} diag(scale^2) U^{-1} = prec(s)^{-1}."""
    mu, scale = _basis_mu_scale(basis, x, w)
    eps = _randn(gen, (n_samples, mu.shape[0]), mu)
    return mu + (eps * scale[None, :]) @ basis.Uinv


def gen_synthetic(gen: torch.Generator, n: int, d: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Synthetic dataset of the gaussian experiment (gaussian/main.py:85):
    x_i = 1 + N(0, I).  Drawn on the generator's device, then moved to
    ``device`` (default: the generator's)."""
    x = 1.0 + torch.randn((n, d), generator=gen, dtype=dtype, device=gen.device)
    return x.to(device if device is not None else gen.device)
