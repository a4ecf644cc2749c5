"""The posterior refits on SparseVI's and BatchPSVI's steps against the JAX
package, after their Cholesky factorizations moved to ``cholesky_ex``.

``torch.linalg.cholesky`` reads its error code back to raise (on a CUDA
device, a synchronization that no captured graph may hold); the port now
factors with ``models.gaussian.cholesky``, which reads nothing and returns
a factor that is NaN on and below its diagonal (0 above) where the
factorization fails, as JAX's ``cholesky`` and ``cho_factor`` return it.
Held here on the same numpy inputs: ``laplace_approx`` for the logistic and Poisson models, cold (25
Newton steps from zero) and warm (3 from a carried mode, as the drivers'
SparseVI steps run it), within rtol 1e-5; the Gaussian and
linear-regression weighted posteriors (rtol 1e-5; the linear-regression QR
refit rtol 1e-4, as ``tests/test_torch_linreg.py`` holds it: another
LAPACK routine on each side); and a Hessian that is not negative definite,
for which both packages return NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.models import gaussian as jg
from bayesian_coresets_tpu.models import laplace as jlap
from bayesian_coresets_tpu.models import linreg as jl
from bayesian_coresets_tpu.models import logistic as jlr
from bayesian_coresets_tpu.models import poisson as jp
from bayesian_coresets_tpu_torch.models import gaussian as tg
from bayesian_coresets_tpu_torch.models import laplace as tlap
from bayesian_coresets_tpu_torch.models import linreg as tl
from bayesian_coresets_tpu_torch.models import logistic as tlr
from bayesian_coresets_tpu_torch.models import poisson as tp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
MODELS = {"logistic": (tlr, jlr), "poisson": (tp, jp)}


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _data(model, n=60, d=4, seed=0):
    """(z, w, theta dimension): folded logistic rows y*x, or Poisson rows
    [x, y] with counts drawn at the model's rate for theta = 0.3."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if model == "logistic":
        return x, w, d
    y = rng.poisson(np.log1p(np.exp(x @ np.full(d, 0.3)))).astype(np.float32)
    return np.hstack([x, y[:, None]]), w, d


def _both(model, z, w, mu0, **kw):
    tm, jm = MODELS[model]
    t = tlap.laplace_approx(torch.as_tensor(z), torch.as_tensor(w), torch.as_tensor(mu0),
                            tm.grad_th_log_joint, tm.hess_th_log_joint, **kw)
    j = jlap.laplace_approx(jnp.asarray(z), jnp.asarray(w), jnp.asarray(mu0),
                            jm.grad_th_log_joint, jm.hess_th_log_joint, **kw)
    return t, j


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("model", ["logistic", "poisson"])
def test_laplace_matches_jax(model, start):
    """Cold: 25 Newton steps from zero; warm: 3 from a mode near the
    optimum (the drivers' warm sampler on SparseVI's steps)."""
    z, w, d = _data(model)
    mu0 = np.zeros(d, np.float32)
    kw = {}
    if start == "warm":
        mu0 = np.asarray(_both(model, z, w * 0.9, mu0)[1].mu)
        kw = dict(num_iters=3)
    t, j = _both(model, z, w, mu0, **kw)
    for f in ("mu", "USig", "LSigInv"):
        _close(getattr(t, f), getattr(j, f))
    assert bool(torch.isfinite(t.USig).all())


@pytest.mark.parametrize("model", ["logistic", "poisson"])
def test_laplace_of_a_hessian_that_is_not_negative_definite_is_nan_in_both(model):
    """-H of the negated Hessian is not positive definite: the first Newton
    step's Cholesky fails in both packages, which return NaN (the port
    raised before)."""
    tm, jm = MODELS[model]
    z, w, d = _data(model, seed=1)
    t = tlap.laplace_approx(torch.as_tensor(z), torch.as_tensor(w), torch.zeros(d),
                            tm.grad_th_log_joint,
                            lambda z, th, w: -tm.hess_th_log_joint(z, th, w))
    j = jlap.laplace_approx(jnp.asarray(z), jnp.asarray(w), jnp.zeros(d),
                            jm.grad_th_log_joint, _negated_hess[model])
    for f in ("mu", "USig", "LSigInv"):     # NaN where JAX's is, 0 where it is
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    assert bool(torch.isnan(t.mu).all())


def _neg_hess_lr(z, th, w):
    return -jlr.hess_th_log_joint(z, th, w)


def _neg_hess_pois(z, th, w):
    return -jp.hess_th_log_joint(z, th, w)


# jit static arguments must be hashable functions defined once
_negated_hess = {"logistic": _neg_hess_lr, "poisson": _neg_hess_pois}


def _gauss_inputs(seed=2, n=30, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    th0 = rng.normal(size=d).astype(np.float32)
    M = rng.normal(size=(d, d))
    Sig0inv = (M @ M.T / d + np.eye(d)).astype(np.float32)
    M = rng.normal(size=(d, d))
    Siginv = (M @ M.T / d + 0.5 * np.eye(d)).astype(np.float32)
    return th0, Sig0inv, Siginv, x, w


def test_gaussian_weighted_post_matches_jax():
    args = _gauss_inputs()
    t = tg.weighted_post(*map(torch.as_tensor, args))
    j = jg.weighted_post(*map(jnp.asarray, args))
    for f in ("mu", "USig", "LSigInv"):
        _close(getattr(t, f), getattr(j, f), rtol=1e-5, atol=1e-5)


def test_gaussian_posterior_of_an_indefinite_precision_is_nan_in_both():
    """Negative weights summing below -1 make Sig0inv + (sum w) Siginv
    indefinite: NaN in both packages, from the refit and from the
    sampler."""
    th0, Sig0inv, Siginv, x, w = _gauss_inputs()
    w = -np.abs(w) * 3.0
    args = (th0, Sig0inv, Siginv, x, w)
    t = tg.weighted_post(*map(torch.as_tensor, args))
    j = jg.weighted_post(*map(jnp.asarray, args))
    for f in ("mu", "USig", "LSigInv"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    assert bool(torch.isnan(t.mu).all())
    s = tg.sample_weighted_post(torch.Generator(), *map(torch.as_tensor, args), 5)
    assert s.shape == (5, 4) and bool(torch.isnan(s).all())


def test_cholesky_reads_nothing_and_keeps_the_layout():
    a = torch.as_tensor(_gauss_inputs()[1])
    L = tg.cholesky(a)
    assert torch.equal(L, torch.linalg.cholesky(a)) and L.stride() == (1, 4)
    bad = tg.cholesky(torch.stack([a, -a]))
    lower = torch.ones((4, 4), dtype=torch.bool).tril()
    assert torch.equal(bad[0], L) and bool(torch.isnan(bad[1][lower]).all())
    assert bool((bad[1][~lower] == 0).all())
    np.testing.assert_array_equal(tg.cholesky(-a).numpy(),
                                  np.asarray(jnp.linalg.cholesky(-jnp.asarray(a.numpy()))))


def test_linreg_weighted_post_matches_jax():
    """The QR refit (its prior factor through the port's Cholesky) and the
    exact family's low-rank refit."""
    rng = np.random.default_rng(3)
    d = 4
    x = rng.normal(size=(25, d)).astype(np.float32)
    z = np.hstack([x, (x @ np.arange(1, d + 1) + rng.normal(size=25)).astype(np.float32)[:, None]])
    w = rng.uniform(0.0, 2.0, size=25).astype(np.float32)
    th0 = rng.normal(size=d).astype(np.float32)
    Sig0inv = (np.eye(d) * 1.5).astype(np.float32)
    t = tl.weighted_post(*map(torch.as_tensor, (th0, Sig0inv)), 0.7, *map(torch.as_tensor, (z, w)))
    j = jl.weighted_post(*map(jnp.asarray, (th0, Sig0inv)), 0.7, *map(jnp.asarray, (z, w)))
    _close(t.mu, j.mu, rtol=1e-4, atol=1e-6)
    _close(t.USig @ t.USig.T, j.USig @ j.USig.T, rtol=1e-4, atol=1e-6)
    tb = tl.lowrank_basis(*map(torch.as_tensor, (th0, Sig0inv)), 0.7)
    jb = jl.lowrank_basis(*map(jnp.asarray, (th0, Sig0inv)), 0.7)
    for f in ("L0inv", "L0invT", "r0", "sigsq"):
        _close(getattr(tb, f).float(), getattr(jb, f))
    tmu, tF = tl.weighted_post_lowrank(tb, torch.as_tensor(z[:3]), torch.as_tensor(w[:3]))
    jmu, jF = jl.weighted_post_lowrank(jb, jnp.asarray(z[:3]), jnp.asarray(w[:3]))
    _close(tmu, jmu, rtol=1e-4, atol=1e-6)
    _close(tF @ tF.T, jF @ jF.T, rtol=1e-4, atol=1e-6)
