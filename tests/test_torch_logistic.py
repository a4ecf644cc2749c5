"""Logistic model and Laplace fit of the PyTorch port against the JAX package.

Inputs are made once with numpy and handed to both.  Elementwise and
contraction results agree to f32 rounding (rtol 1e-5, atol 1e-6); the
Laplace fit runs 25 f32 Newton steps with Cholesky factorizations taken in
another order, hence rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.models import laplace as jlap
from bayesian_coresets_tpu.models import logistic as jlr
from bayesian_coresets_tpu_torch.models import laplace as tlap
from bayesian_coresets_tpu_torch.models import logistic as tlr
from bayesian_coresets_tpu_torch.utils import interop

torch.set_num_threads(1)

N, D, S = 64, 5, 16


def _inputs(scale, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(N, D)).astype(np.float32)
    th = (scale * rng.normal(size=(S, D))).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=N).astype(np.float32)
    return z, th, w


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


# scale 1: logits of order 1; scale 20: logits far beyond ±20, where the
# softplus form matters (F.softplus's threshold=20 cut would differ)
@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_log_likelihood(scale):
    z, th, _ = _inputs(scale)
    if scale > 1:
        assert np.abs(z @ th.T).max() > 40
    _close(tlr.log_likelihood(torch.as_tensor(z), torch.as_tensor(th)),
           jlr.log_likelihood(jnp.asarray(z), jnp.asarray(th)))


def test_softplus_form_is_exact_beyond_threshold():
    x = torch.tensor([-60.0, -25.0, -20.5, 0.0, 20.5, 25.0, 60.0])
    want = np.logaddexp(x.double().numpy(), 0.0)
    np.testing.assert_allclose(tlr._softplus(x).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_log_prior_and_joint(scale):
    z, th, w = _inputs(scale)
    zt, tt, wt = map(torch.as_tensor, (z, th, w))
    _close(tlr.log_prior(tt), jlr.log_prior(jnp.asarray(th)))
    _close(tlr.log_joint(zt, tt, wt),
           jlr.log_joint(jnp.asarray(z), jnp.asarray(th), jnp.asarray(w)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_gradients(scale):
    z, th, w = _inputs(scale)
    zt, tt, wt = map(torch.as_tensor, (z, th, w))
    zj, tj, wj = map(jnp.asarray, (z, th, w))
    _close(tlr.grad_th_log_likelihood(zt, tt), jlr.grad_th_log_likelihood(zj, tj))
    _close(tlr.grad_th_log_prior(tt), jlr.grad_th_log_prior(tj))
    _close(tlr.grad_th_log_joint(zt, tt, wt), jlr.grad_th_log_joint(zj, tj, wj))


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_hess_th_log_joint(scale):
    z, th, w = _inputs(scale)
    _close(tlr.hess_th_log_joint(*map(torch.as_tensor, (z, th, w))),
           jlr.hess_th_log_joint(*map(jnp.asarray, (z, th, w))))


def test_one_dim_theta_is_one_sample():
    z, th, _ = _inputs(1.0)
    out = tlr.log_likelihood(torch.as_tensor(z), torch.as_tensor(th[0]))
    assert out.shape == (N, 1)
    _close(out, jlr.log_likelihood(jnp.asarray(z), jnp.asarray(th[0])))


def _lr_data(seed=0, n=500, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-x @ np.full(d, 1.5))), 1.0, -1.0)
    return (y[:, None] * x).astype(np.float32)


def test_laplace_approx_matches():
    z = _lr_data()
    w = np.ones(z.shape[0], np.float32)
    j = jlap.laplace_approx(jnp.asarray(z), jnp.asarray(w), jnp.zeros(D),
                            grad_fn=jlr.grad_th_log_joint, hess_fn=jlr.hess_th_log_joint)
    t = tlap.laplace_approx(torch.as_tensor(z), torch.as_tensor(w), torch.zeros(D),
                            grad_fn=tlr.grad_th_log_joint, hess_fn=tlr.hess_th_log_joint)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    # USig = L^{-T}: Sig = USig USig^T inverts LSigInv LSigInv^T
    sig = t.USig @ t.USig.T
    np.testing.assert_allclose((sig @ (t.LSigInv @ t.LSigInv.T)).numpy(), np.eye(D),
                               atol=1e-4)


def test_sample_laplace_draws_through_the_factor():
    z = _lr_data(1)
    w = np.ones(z.shape[0], np.float32)
    j = jlap.laplace_approx(jnp.asarray(z), jnp.asarray(w), jnp.zeros(D),
                            grad_fn=jlr.grad_th_log_joint, hess_fn=jlr.hess_th_log_joint)
    res = interop.laplace_result(type(j)(*map(np.asarray, j)))
    th = tlap.sample_laplace(torch.Generator().manual_seed(3), res, 7)
    eps = torch.randn((7, D), generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(th.numpy(), (res.mu + eps @ res.USig.T).numpy(), rtol=1e-6)
    assert th.shape == (7, D)


def test_gen_synthetic_folds_labels():
    z = tlr.gen_synthetic(torch.Generator().manual_seed(0), 4000, 3)
    assert z.shape == (4000, 3) and z.dtype == torch.float32
    # z = y*x with P(y=1) = sigmoid(3 * sum x): most rows lean along +theta
    frac = float((z.sum(dim=1) > 0).double().mean())
    assert 0.8 < frac < 1.0
