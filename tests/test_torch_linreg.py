"""The port's linear-regression model and its exact tangent family against
the JAX package's, on numpy inputs made from a seed: f32 within rtol 1e-5,
atol 1e-6; the posterior refits (``weighted_post`` by QR,
``weighted_post_lowrank`` by an eigh of the Gram) within rtol 1e-4 on the
mean and on the covariance F F^T, since the factorizations come from other
LAPACK routines on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.coresets import exact as jexact
from bayesian_coresets_tpu.models import linreg as jl
from bayesian_coresets_tpu_torch.coresets import exact as texact
from bayesian_coresets_tpu_torch.models import gaussian as tg
from bayesian_coresets_tpu_torch.models import linreg as tl

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
POST_TOL = dict(rtol=1e-4, atol=1e-6)
N, D, S, SIGSQ = 30, 4, 6, 0.7


def _inputs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (x @ np.arange(1, D + 1) + np.sqrt(SIGSQ) * rng.normal(size=n)).astype(np.float32)
    z = np.concatenate([x, y[:, None]], axis=1)
    th = rng.normal(size=(S, D)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    th0 = rng.normal(size=D).astype(np.float32)
    M = rng.normal(size=(D, D))
    Sig0inv = (M @ M.T / D + np.eye(D)).astype(np.float32)
    return z, th, w, th0, Sig0inv


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_log_likelihood_and_gradient_match_jax():
    z, th, *_ = _inputs()
    np.testing.assert_allclose(tl.log_likelihood(*_t(z, th), SIGSQ).numpy(),
                               np.asarray(jl.log_likelihood(*_j(z, th), SIGSQ)), **TOL)
    # sigsq as a tensor, one theta and one row
    got = tl.log_likelihood(*_t(z[0], th[0]), torch.tensor(SIGSQ))
    assert got.shape == (1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.log_likelihood(*_j(z[0], th[0]), SIGSQ)),
                               **TOL)
    g = tl.grad_x_log_likelihood(*_t(z, th), SIGSQ)
    assert g.shape == (N, S, D + 1)
    np.testing.assert_allclose(g.numpy(), np.asarray(jl.grad_x_log_likelihood(*_j(z, th), SIGSQ)),
                               **TOL)
    # the d/dy entry has the corrected sign: it is the derivative
    zt, tht = _t(z, th)
    zt.requires_grad_(True)
    tl.log_likelihood(zt, tht, SIGSQ)[:, 2].sum().backward()
    np.testing.assert_allclose(g[:, 2, :].numpy(), zt.grad.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("zero_weights", [False, True])
def test_weighted_post_matches_jax(zero_weights):
    z, _, w, th0, Sig0inv = _inputs(1)
    if zero_weights:
        w = np.zeros_like(w)
    tpost = tl.weighted_post(*_t(th0, Sig0inv), SIGSQ, *_t(z, w))
    jpost = jl.weighted_post(*_j(th0, Sig0inv), SIGSQ, *_j(z, w))
    np.testing.assert_allclose(tpost.mu.numpy(), np.asarray(jpost.mu), **POST_TOL)
    # R is sign-normalized, so the factors themselves agree
    np.testing.assert_allclose(tpost.USig.numpy(), np.asarray(jpost.USig), **POST_TOL)
    np.testing.assert_allclose(tpost.LSigInv.numpy(), np.asarray(jpost.LSigInv), **POST_TOL)
    assert bool((torch.diagonal(tpost.LSigInv) > 0).all())
    assert float(torch.triu(tpost.LSigInv, 1).abs().max()) == 0.0
    # against the normal equations in f64
    x, y = z[:, :-1].astype(np.float64), z[:, -1].astype(np.float64)
    prec = Sig0inv + (x.T * w) @ x / SIGSQ
    mu = np.linalg.solve(prec, Sig0inv @ th0 + x.T @ (w * y) / SIGSQ)
    np.testing.assert_allclose(tpost.mu.numpy(), mu, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose((tpost.USig @ tpost.USig.T).numpy(), np.linalg.inv(prec),
                               rtol=1e-3, atol=1e-6)
    if zero_weights:
        np.testing.assert_allclose(tpost.mu.numpy(), th0, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("m", [3, 12])
def test_weighted_post_lowrank_matches_jax(m):
    """m rows below and above the parameter dimension (a rank-deficient and
    a full-rank Gram); a zero weight among them."""
    z, _, w, th0, Sig0inv = _inputs(2, n=m)
    w[1] = 0.0
    tb = tl.lowrank_basis(*_t(th0, Sig0inv), SIGSQ)
    jb = jl.lowrank_basis(*_j(th0, Sig0inv), SIGSQ)
    for f in ("L0inv", "L0invT", "r0", "sigsq"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), **TOL)
    tmu, tF = tl.weighted_post_lowrank(tb, *_t(z, w))
    jmu, jF = jl.weighted_post_lowrank(jb, *_j(z, w))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **POST_TOL)
    np.testing.assert_allclose((tF @ tF.T).numpy(), np.asarray(jF @ jF.T), **POST_TOL)
    # and it is the QR posterior
    post = tl.weighted_post(*_t(th0, Sig0inv), SIGSQ, *_t(z, w))
    np.testing.assert_allclose(tmu.numpy(), post.mu.numpy(), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose((tF @ tF.T).numpy(), (post.USig @ post.USig.T).numpy(),
                               rtol=1e-3, atol=1e-6)


def test_sample_weighted_post_moments():
    z, _, w, th0, Sig0inv = _inputs(3)
    args = _t(th0, Sig0inv)
    post = tl.weighted_post(*args, SIGSQ, *_t(z, w))
    s = tl.sample_weighted_post(torch.Generator().manual_seed(0), *args, SIGSQ, *_t(z, w), 40000)
    assert s.shape == (40000, D)
    sd = torch.sqrt(torch.diagonal(post.USig @ post.USig.T))
    assert float(((s.mean(dim=0) - post.mu).abs() / sd).max()) < 0.03
    np.testing.assert_allclose(torch.cov(s.T).numpy(), (post.USig @ post.USig.T).numpy(),
                               rtol=0.05, atol=2e-4)
    js = jl.sample_weighted_post(jax.random.key(0), *_j(th0, Sig0inv), SIGSQ, *_j(z, w), 40000)
    assert float(((s.mean(dim=0).numpy() - np.asarray(js).mean(0)) / sd.numpy()).max()) < 0.03


def test_rbf_features_and_kl_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(20, 2)).astype(np.float32)
    centers = rng.normal(size=(5, 2)).astype(np.float32)
    scales = np.array([0.5, 1.0, 3.0], np.float32)
    got = tl.rbf_features(*_t(x, centers, scales))
    assert got.shape == (20, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.rbf_features(*_j(x, centers, scales))),
                               **TOL)
    assert tl.kl_divergence is tg.kl_divergence and tl.WeightedPost is tg.WeightedPost


@pytest.mark.parametrize("lowrank_refit", [None, False, True])
@pytest.mark.parametrize("m", [3, 9])
def test_linreg_tangent_family_matches_jax(m, lowrank_refit):
    """``make_ctx`` and ``project`` on given (wts, pts), on both refit
    branches: the default takes the low-rank refit for m <= d slots and the
    QR otherwise.  The features depend on the covariance factor, so they are
    compared where both packages take the same branch, through the factor's
    Gram (X F F^T X^T and the projected quadratic block's Gram)."""
    z, _, w, th0, Sig0inv = _inputs(5)
    pts, wts = z[:m], w[:m]
    rng = np.random.default_rng(6)
    bV = np.linalg.qr(rng.normal(size=(D, 2)))[0].astype(np.float32)
    tf = texact.linreg_tangent_family(*_t(th0, Sig0inv), SIGSQ, torch.as_tensor(bV),
                                      lowrank_refit=lowrank_refit)
    jf = jexact.linreg_tangent_family(*_j(th0, Sig0inv), SIGSQ, jnp.asarray(bV),
                                      lowrank_refit=lowrank_refit)
    tmu, tF = tf.make_ctx(None, *_t(wts, pts))
    jmu, jF = jf.make_ctx(None, *_j(wts, pts))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **POST_TOL)
    np.testing.assert_allclose((tF @ tF.T).numpy(), np.asarray(jF @ jF.T), **POST_TOL)
    use_lr = (m <= D) if lowrank_refit is None else lowrank_refit
    assert bool(torch.equal(tF, torch.triu(tF))) == (not use_lr)     # QR gives a triangle
    # project on the JAX package's own context: the same function of it
    ctx = (torch.tensor(np.asarray(jmu)), torch.tensor(np.asarray(jF)))
    feats = tf.project(ctx, torch.as_tensor(z))
    assert feats.shape == (N, D + 4) and tf.project_grad is None
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf.project((jmu, jF), jnp.asarray(z))),
                               rtol=1e-5, atol=1e-5)
    # the empty coreset gives the prior
    pmu, _ = tf.make_ctx(None, torch.zeros(0), torch.zeros((0, D + 1)))
    np.testing.assert_allclose(pmu.numpy(), th0, rtol=1e-4, atol=1e-5)


def test_sparsevi_builds_on_the_linreg_family():
    """The family serves SparseVI as the Gaussian one does: a short build
    on both refit branches lowers the KL to the full-data posterior."""
    import bayesian_coresets_tpu_torch as tbc

    z, _, _, th0, Sig0inv = _inputs(7, n=200)
    zt, th0t, S0t = _t(z, th0, Sig0inv)
    bV = torch.linalg.eigh(zt[:, :-1].T @ zt[:, :-1])[1][:, -2:]
    full = tl.weighted_post(th0t, S0t, SIGSQ, zt, torch.ones(200))
    kls = []
    for cap in (4, 16):                                   # m <= d: low rank; m > d: QR
        fam = tbc.linreg_tangent_family(th0t, S0t, SIGSQ, bV)
        c = tbc.SparseVICoreset(zt, fam, opt_itrs=30, capacity=cap, seed=0)
        c.build(4)
        w, p, i = c.get()
        assert 0 < i.size <= 4 and np.isfinite(w).all() and (w >= 0).all()
        post = tl.weighted_post(th0t, S0t, SIGSQ, *_t(p, w))
        kls.append(tg.kl_divergence_np(post.mu, post.USig @ post.USig.T, full.mu,
                                       full.LSigInv @ full.LSigInv.T))
    prior = tl.weighted_post(th0t, S0t, SIGSQ, zt[:1], torch.zeros(1))
    kl0 = tg.kl_divergence_np(prior.mu, prior.USig @ prior.USig.T, full.mu,
                              full.LSigInv @ full.LSigInv.T)
    assert max(kls) < 0.5 * kl0
