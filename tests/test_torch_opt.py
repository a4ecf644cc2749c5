"""Projected Adam of the port (``ops/opt.py``) against the JAX package.

The semantics of ``tests/test_opt.py``: the projected quadratic optimum,
the partial mask, and the exact Adam recursion on a deterministic gradient
(held to the JAX package's ``nn_opt`` on the same gradient within rtol 1e-5,
f32 rounding of the same recursion, and to a NumPy replay).  Every step
hands the gradient a generator that has advanced, so steps draw fresh
values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.ops import nn_opt as jnn_opt
from bayesian_coresets_tpu_torch.ops import nn_opt

torch.set_num_threads(1)


def test_converges_to_projected_quadratic_optimum():
    # min 0.5||x - t||^2 with x >= 0  ->  x* = max(t, 0)
    t = np.asarray([1.5, -2.0, 0.3, -0.1], np.float32)
    x = nn_opt(torch.zeros(4), lambda x, g: x - torch.as_tensor(t), torch.Generator(),
               opt_itrs=2000, step_sched=lambda i: 0.05)
    np.testing.assert_allclose(x.numpy(), np.maximum(t, 0), atol=1e-3)
    xj = jnn_opt(jnp.zeros(4), lambda x, k: x - jnp.asarray(t), jax.random.key(0),
                 opt_itrs=2000, step_sched=lambda i: 0.05)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-6)


def test_partial_constraint_mask():
    t = torch.tensor([-1.0, -1.0])
    mask = torch.tensor([True, False])    # only x0 constrained
    x = nn_opt(torch.zeros(2), lambda x, g: x - t, torch.Generator(), nn_mask=mask,
               opt_itrs=2000, step_sched=lambda i: 0.05)
    assert abs(float(x[0])) < 1e-3
    assert abs(float(x[1]) + 1.0) < 1e-3


@pytest.mark.parametrize("sched", ["harmonic", "constant"])
def test_matches_reference_adam_recursion(sched):
    step = (lambda i: 1.0 / (1.0 + i)) if sched == "harmonic" else (lambda i: 0.02)
    rng = np.random.default_rng(0)
    t = rng.normal(size=5).astype(np.float32)
    b1, b2, eps = 0.9, 0.999, 1e-8
    x_np = np.zeros(5, np.float32)
    m1 = np.zeros(5, np.float32)
    m2 = np.zeros(5, np.float32)
    for i in range(50):
        g = x_np - t
        m1 = b1 * m1 + (1 - b1) * g
        m2 = b2 * m2 + (1 - b2) * g**2
        upd = step(i) * (m1 / (1 - b1 ** (i + 1))) / (eps + np.sqrt(m2 / (1 - b2 ** (i + 1))))
        x_np = np.maximum(x_np - upd, 0.0)

    x = nn_opt(torch.zeros(5), lambda x, g: x - torch.as_tensor(t), torch.Generator(),
               opt_itrs=50, step_sched=step)
    xj = jnn_opt(jnp.zeros(5), lambda x, k: x - jnp.asarray(t), jax.random.key(0),
                 opt_itrs=50, step_sched=step)
    np.testing.assert_allclose(x.numpy(), x_np, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-6)


def test_steps_draw_fresh_values_and_thread_aux():
    seen = []

    def grad_fn(x, g, aux):
        r = torch.randn(x.shape, generator=g)
        seen.append(r)
        return r, aux + 1

    gen = torch.Generator().manual_seed(0)
    x1, n = nn_opt(torch.ones(3), grad_fn, gen, opt_itrs=10, step_sched=lambda i: 0.1,
                   aux0=torch.tensor(0))
    assert int(n) == 10
    draws = torch.stack(seen)
    assert len({tuple(r.tolist()) for r in draws}) == 10      # every step drew anew
    # the same seed reproduces; another seed does not
    seen.clear()
    x1b, _ = nn_opt(torch.ones(3), grad_fn, torch.Generator().manual_seed(0), opt_itrs=10,
                    step_sched=lambda i: 0.1, aux0=torch.tensor(0))
    seen.clear()
    x2, _ = nn_opt(torch.ones(3), grad_fn, torch.Generator().manual_seed(1), opt_itrs=10,
                   step_sched=lambda i: 0.1, aux0=torch.tensor(0))
    assert torch.equal(x1, x1b)
    assert not torch.allclose(x1, x2)
    assert (x1 >= 0).all() and (x2 >= 0).all()
