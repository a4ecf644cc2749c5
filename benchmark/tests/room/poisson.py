"""Poisson regression with a softplus rate, a second model for the room
test (``test_bench_room.py``): its rows, the program's log-likelihood by
name, and a plain one in float64.

Rows are [x, y] (the reference's ``examples/common/model_poiss.py:4-38`` of
trevorcampbell/bayesian-coresets): D covariates, the last an intercept of
1, the others N(0, 1); the count y ~ Poisson(softplus(x . 1)).  A row has
D + 1 columns, and a projection sample D entries.
"""

from __future__ import annotations

import torch

PROGRAM_LOGLIK = "bayesian_coresets_tpu_torch.models.poisson:log_likelihood"


def _softplus(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def rows(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """(n, d + 1) f32 rows [x, y] on the generator's device."""
    dev = gen.device
    x = torch.randn((n, d), generator=gen, dtype=torch.float32, device=dev)
    x[:, -1] = 1.0
    y = torch.poisson(_softplus(x.sum(dim=1)), generator=gen)
    return torch.cat([x, y[:, None]], dim=1)


def loglik(z: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(n, S) log p(y | x, theta) = y log(lam) - log(y!) - lam, with lam =
    softplus(x . theta)."""
    x, y = z[:, :-1], z[:, -1:]
    lam = _softplus(x @ theta.T)
    return y * torch.log(lam) - torch.lgamma(y + 1.0) - lam
