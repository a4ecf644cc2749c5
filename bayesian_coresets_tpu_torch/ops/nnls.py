"""Non-negative least squares on a small active set, on the data's device.

Port of ``bayesian_coresets_tpu/ops/nnls.py``: a fixed-iteration
accelerated projected gradient (FISTA with adaptive restart) on the
gathered active-set system.  The active set is small (at most the coreset
size), so the Gram matrix is a (K, K) block and the solve costs nothing
that scales with n.  The Gram products are plain ``torch`` matmuls, as the
JAX package computes them outside any Pallas kernel.  The loops run a fixed
number of iterations and read nothing back to the host (the JAX package's
``fori_loop``), so a CUDA graph captures a whole solve
(``snnls.optimize_active``).
"""

from __future__ import annotations

import math

import torch


def _power_iteration_sym(G: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Largest eigenvalue of a symmetric PSD matrix (Lipschitz constant)."""
    k = G.shape[0]
    v = torch.full((k,), 1.0 / math.sqrt(k), dtype=G.dtype, device=G.device)
    for _ in range(iters):
        v = G @ v
        nrm = torch.sqrt(torch.sum(v * v))
        v = v / torch.where(nrm == 0, 1.0, nrm)
    return torch.clamp_min(v @ (G @ v), 1e-12)


def nnls_gram(G: torch.Tensor, c: torch.Tensor, num_iters: int = 512,
              x0: torch.Tensor | None = None) -> torch.Tensor:
    """min_x 0.5 x^T G x - c^T x  s.t. x >= 0, via FISTA with restart.

    G: (K, K) PSD Gram matrix; c: (K,).
    """
    step = 1.0 / _power_iteration_sym(G)
    x = torch.zeros_like(c) if x0 is None else torch.clamp_min(x0, 0.0)
    y = x
    t = torch.ones((), dtype=c.dtype, device=c.device)
    for _ in range(num_iters):
        grad = G @ y - c
        x_new = torch.clamp_min(y - step * grad, 0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        mom = (t - 1.0) / t_new
        # adaptive restart: if momentum points uphill, reset it
        restart = torch.dot(y - x_new, x_new - x) > 0
        mom = torch.where(restart, 0.0, mom)
        t = torch.where(restart, 1.0, t_new)
        y = x_new + mom * (x_new - x)
        x = x_new
    return x


def nnls_rows(Aact: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
              num_iters: int = 512, x0: torch.Tensor | None = None) -> torch.Tensor:
    """NNLS on pre-gathered rows: min ||Aact^T x - b||, x >= 0.

    Aact: (K, S) gathered active rows, zeroed at padding; mask: (K,) live-row
    mask.  The normal equations G = Aact Aact^T, c = Aact b reduce the solve
    to a (K, K) problem independent of n.
    """
    G = Aact @ Aact.T
    # unit diagonal on padded rows keeps G nonsingular without affecting live rows
    G = G + torch.diag(torch.where(mask, 0.0, 1.0).to(G.dtype))
    c = Aact @ b
    x = nnls_gram(G, c, num_iters=num_iters, x0=x0)
    return torch.where(mask, x, 0.0)


def nnls_active_set(V: torch.Tensor, b: torch.Tensor, idcs: torch.Tensor, size,
                    num_iters: int = 512, x0: torch.Tensor | None = None) -> torch.Tensor:
    """NNLS restricted to active columns of A = V.T.

    V: (n, S) data-major projection matrix; idcs: (K,) padded active indices;
    size: number of live entries in idcs.  Returns (K,) weights (0 at padding).
    """
    K = idcs.shape[0]
    mask = torch.arange(K, device=idcs.device) < size
    safe = torch.where(mask, idcs, 0)
    Aact = torch.where(mask[:, None], V.index_select(0, safe), 0.0)
    return nnls_rows(Aact, b, mask, num_iters=num_iters, x0=x0)
