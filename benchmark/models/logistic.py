"""Logistic regression, the model of the Hilbert cells: its rows, the
program's log-likelihood by name, and the plain reference's in float64.

The synthetic data is the reference's (``examples/common/model_lr.py:15-23``
of trevorcampbell/bayesian-coresets): x ~ N(0, I), theta = 3 * 1, y = +1
with probability sigmoid(x . theta), else -1, and the rows are folded,
z = y * x.  A row has D columns, and a projection sample D entries.
"""

from __future__ import annotations

import torch

# the program's log-likelihood, "module:function", imported by the job that runs it
PROGRAM_LOGLIK = "bayesian_coresets_tpu_torch.models.logistic:log_likelihood"
THETA_TRUE = 3.0          # model_lr.py:17, the generating coefficient of every dimension


def rows(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """(n, d) f32 folded logistic rows on the generator's device."""
    dev = gen.device
    x = torch.randn((n, d), generator=gen, dtype=torch.float32, device=dev)
    ps = torch.sigmoid(x @ torch.full((d,), THETA_TRUE, dtype=torch.float32, device=dev))
    u = torch.rand((n,), generator=gen, dtype=torch.float32, device=dev)
    y = torch.where(u <= ps, 1.0, -1.0)
    return y[:, None] * x


def loglik(z: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(n, S) log p(y | x, theta) = -log(1 + exp(-z . theta)), stably."""
    m = -(z @ theta.T)
    return -(torch.clamp_min(m, 0.0) + torch.log1p(torch.exp(-m.abs())))
