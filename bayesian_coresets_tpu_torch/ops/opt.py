"""Projected Adam for (partially) nonnegativity-constrained objectives.

Port of ``bayesian_coresets_tpu/ops/opt.py`` (reference util/opt.py:4-28):
the bias-corrected Adam update ``step_sched(i) * m1_hat / (eps +
sqrt(m2_hat))`` followed by clamping the constrained coordinates at zero.
SparseVI and BatchPSVI redraw Monte Carlo samples inside every gradient
evaluation, so the gradient callback is handed the draw source (a
``torch.Generator``) at every step; it advances, so every step draws fresh
values.

Where the JAX package runs a ``lax.scan``, this is a Python loop that reads
nothing back to the host.  The step constants (``step_sched(i)`` and the
bias corrections ``1 - b**(i+1)``) are computed once, as f32 tensors on the
iterate's device over an f32 step index, as the JAX package computes them;
the update divides only by tensors (CUDA divides by a Python scalar by
multiplying with its reciprocal, the CPU does not).
"""

from __future__ import annotations

from typing import Callable

import torch


def nn_opt(
    x0: torch.Tensor,
    grad_fn: Callable,                    # (x, gen) -> grad, or with aux below
    gen: torch.Generator,
    nn_mask: torch.Tensor | None = None,  # True where x is constrained >= 0
    opt_itrs: int = 1000,
    step_sched: Callable = lambda i: 1.0 / (1.0 + i),
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    aux0=None,                            # carried state threaded through the steps
):
    """Run ``opt_itrs`` projected-Adam steps; returns the final iterate.

    ``nn_mask=None`` clamps every coordinate.  ``step_sched`` is called
    once, on the f32 tensor of step indices 0..opt_itrs-1 (a constant
    schedule may return a number).  With ``aux0`` given,
    ``grad_fn(x, gen, aux) -> (grad, aux)`` threads a carried state through
    the steps and ``(x, aux)`` is returned.
    """
    dt, dev = x0.dtype, x0.device
    mask = torch.ones_like(x0, dtype=torch.bool) if nn_mask is None else nn_mask
    steps = torch.arange(opt_itrs, dtype=dt, device=dev)
    lr = torch.as_tensor(step_sched(steps), dtype=dt, device=dev).expand(opt_itrs)
    c1 = 1.0 - torch.pow(b1, steps + 1.0)
    c2 = 1.0 - torch.pow(b2, steps + 1.0)
    with_aux = aux0 is not None
    x, aux = x0, aux0
    m1, m2 = torch.zeros_like(x0), torch.zeros_like(x0)
    for i in range(opt_itrs):
        if with_aux:
            g, aux = grad_fn(x, gen, aux)
        else:
            g = grad_fn(x, gen)
        m1 = b1 * m1 + (1.0 - b1) * g
        m2 = b2 * m2 + (1.0 - b2) * g * g
        m1_hat = m1 / c1[i]
        m2_hat = m2 / c2[i]
        x = x - lr[i] * m1_hat / (eps + torch.sqrt(m2_hat))
        x = torch.where(mask, torch.clamp_min(x, 0.0), x)
    return (x, aux) if with_aux else x
