"""The conjugate Gaussian model, the projector extensions and the exact
tangent families of the port against the JAX package, and the logistic
and Laplace extras that SparseVI and BatchPSVI use on logistic data.

Same numpy inputs on both sides.  Closed forms and projections agree within
rtol 1e-5 (f32 matmuls summed in other orders); f64 host KLs exactly.  The
eigenbasis of ``posterior_basis`` is not unique where eigenvalues repeat
(Sig0inv = Siginv = I gives A = I), so exact features are compared
elementwise with the JAX basis carried across, and with the port's own
basis on what does not depend on the choice: the posterior mean, the
covariance, and the Gram of the features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_coresets_tpu as jbc
import bayesian_coresets_tpu_torch as tbc
from bayesian_coresets_tpu.models import gaussian as jg
from bayesian_coresets_tpu.models import laplace as jlap
from bayesian_coresets_tpu.models import logistic as jlr
from bayesian_coresets_tpu_torch.models import gaussian as tg
from bayesian_coresets_tpu_torch.models import laplace as tlap
from bayesian_coresets_tpu_torch.models import logistic as tlr
from bayesian_coresets_tpu_torch.utils import config, interop

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


RT = dict(rtol=1e-5, atol=1e-5)
D = 6


def _spd(rng, d):
    X = rng.normal(size=(d, 2 * d))
    return (X @ X.T / (2 * d) + 0.5 * np.eye(d)).astype(np.float32)


def _setup(seed=0, identity=False, n=40):
    rng = np.random.default_rng(seed)
    mu0 = (0.3 * rng.normal(size=D)).astype(np.float32)
    S0i = np.eye(D, dtype=np.float32) if identity else _spd(rng, D)
    Si = np.eye(D, dtype=np.float32) if identity else _spd(rng, D)
    x = (1.0 + rng.normal(size=(n, D))).astype(np.float32)
    w = rng.uniform(0.0, 3.0, size=n).astype(np.float32)
    th = rng.normal(size=(9, D)).astype(np.float32)
    return mu0, S0i, Si, x, w, th


def _t(*a):
    return [torch.as_tensor(v) for v in a]


def _j(*a):
    return [jnp.asarray(v) for v in a]


def test_log_likelihood_and_grad_match_jax():
    mu0, S0i, Si, x, w, th = _setup()
    np.testing.assert_allclose(tg.log_likelihood(*_t(x, th, Si), 0.3).numpy(),
                               np.asarray(jg.log_likelihood(*_j(x, th, Si), 0.3)), **RT)
    np.testing.assert_allclose(tg.grad_x_log_likelihood(*_t(x, th, Si)).numpy(),
                               np.asarray(jg.grad_x_log_likelihood(*_j(x, th, Si))), **RT)
    # a single point and a single sample broadcast as in JAX
    np.testing.assert_allclose(tg.log_likelihood(*_t(x[0], th[0], Si), 0.0).numpy(),
                               np.asarray(jg.log_likelihood(*_j(x[0], th[0], Si), 0.0)), **RT)


def test_weighted_post_and_kl_match_jax():
    mu0, S0i, Si, x, w, th = _setup(1)
    tp = tg.weighted_post(*_t(mu0, S0i, Si, x, w))
    jp = jg.weighted_post(*_j(mu0, S0i, Si, x, w))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # an empty coreset gives the prior
    e = tg.weighted_post(*_t(mu0, S0i, Si), torch.zeros((0, D)), torch.zeros(0))
    np.testing.assert_allclose(e.mu.numpy(), mu0, rtol=1e-5, atol=1e-6)
    Sig = tp.USig @ tp.USig.T
    q = tg.weighted_post(*_t(mu0, S0i, Si, x[:10], w[:10]))
    qj = jg.weighted_post(*_j(mu0, S0i, Si, x[:10], w[:10]))
    kt = tg.kl_divergence(q.mu, q.USig @ q.USig.T, tp.mu, tp.LSigInv @ tp.LSigInv.T)
    kj = jg.kl_divergence(qj.mu, qj.USig @ qj.USig.T, jp.mu, jp.LSigInv @ jp.LSigInv.T)
    np.testing.assert_allclose(float(kt), float(kj), rtol=1e-4)
    # host f64: tensors and arrays give the same bits; KL(p||p) = 0
    args = (q.mu, q.USig @ q.USig.T, tp.mu, tp.LSigInv @ tp.LSigInv.T)
    k64 = tg.kl_divergence_np(*args)
    assert k64 == tg.kl_divergence_np(*(a.numpy() for a in args))
    assert k64 == jg.kl_divergence_np(*(a.numpy() for a in args))
    np.testing.assert_allclose(float(kt), k64, rtol=1e-4)
    assert abs(tg.kl_divergence_np(tp.mu, Sig, tp.mu, torch.linalg.inv(Sig))) < 1e-5


@pytest.mark.parametrize("identity", [False, True])
def test_posterior_basis_matches_jax(identity):
    mu0, S0i, Si, x, w, _ = _setup(2, identity)
    jb = jg.posterior_basis(*_j(mu0, S0i, Si))
    carried = interop.posterior_basis(type(jb)(*map(np.asarray, jb)))
    own = tg.posterior_basis(*_t(mu0, S0i, Si))
    np.testing.assert_allclose(own.lam.numpy(), np.asarray(jb.lam), rtol=1e-5, atol=1e-6)
    jmu, jF = jg.weighted_post_basis(jb, *_j(x, w))
    exact = jg.weighted_post(*_j(mu0, S0i, Si, x, w))
    for basis in (carried, own):
        mu, F = tg.weighted_post_basis(basis, *_t(x, w))
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose((F @ F.T).numpy(), np.asarray(jF @ jF.T), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose((F @ F.T).numpy(), np.asarray(exact.USig @ exact.USig.T),
                                   rtol=1e-4, atol=1e-6)
    mu, F = tg.weighted_post_basis(carried, *_t(x, w))
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=1e-5, atol=1e-6)


def test_samplers_draw_the_posterior():
    mu0, S0i, Si, x, w, _ = _setup(3, n=8)
    post = tg.weighted_post(*_t(mu0, S0i, Si, x, w))
    Sig = (post.USig @ post.USig.T).double()
    basis = tg.posterior_basis(*_t(mu0, S0i, Si))
    for draw in (lambda g: tg.sample_weighted_post(g, *_t(mu0, S0i, Si, x, w), 40000),
                 lambda g: tg.sample_weighted_post_basis(g, basis, *_t(x, w), 40000)):
        a = draw(torch.Generator().manual_seed(4))
        b = draw(torch.Generator().manual_seed(4))
        np.testing.assert_array_equal(a.numpy(), b.numpy())          # seeded
        assert not np.array_equal(a.numpy(), draw(torch.Generator().manual_seed(5)).numpy())
        sd = torch.sqrt(torch.diagonal(Sig))
        assert float(torch.max(torch.abs(a.double().mean(0) - post.mu) / sd)) < 0.03
        np.testing.assert_allclose(torch.cov(a.double().T).numpy(), Sig.numpy(), atol=0.03)
    g = tg.gen_synthetic(torch.Generator().manual_seed(0), 5000, D)
    assert g.shape == (5000, D) and g.dtype == torch.float32
    assert abs(float(g.mean()) - 1.0) < 0.05 and abs(float(g.std()) - 1.0) < 0.05


def test_center_glls_and_project_grad_match_jax():
    mu0, S0i, Si, x, w, th = _setup(4)
    gl = np.array(jg.grad_x_log_likelihood(*_j(x, th, Si)))
    np.testing.assert_allclose(tbc.center_glls(torch.as_tensor(gl)).numpy(),
                               np.asarray(jbc.coresets.center_glls(jnp.asarray(gl))), **RT)
    jfam = jbc.coresets.blackbox_family(
        lambda k, n, w, p: jnp.asarray(th), 9,
        lambda p, t: jg.log_likelihood(p, t, jnp.asarray(Si), 0.0),
        lambda p, t: jg.grad_x_log_likelihood(p, t, jnp.asarray(Si)))
    tfam = tbc.coresets.blackbox_family(
        lambda g, n, w, p: torch.as_tensor(th), 9,
        lambda p, t: tg.log_likelihood(p, t, torch.as_tensor(Si), 0.0),
        lambda p, t: tg.grad_x_log_likelihood(p, t, torch.as_tensor(Si)))
    jl, jgr = jbc.coresets.project(jfam, jnp.asarray(th), jnp.asarray(x), grad=True)
    tl, tgr = tbc.project(tfam, torch.as_tensor(th), torch.as_tensor(x), grad=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **RT)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), **RT)
    np.testing.assert_allclose(tgr.sum(dim=1).numpy(), 0.0, atol=1e-4)   # centered
    # the stateful projector, and a family without gradients
    prj = tbc.BlackBoxProjector(lambda g, n, w, p: torch.as_tensor(th), 9,
                                lambda p, t: tg.log_likelihood(p, t, torch.as_tensor(Si), 0.0))
    np.testing.assert_allclose(prj.project(x).numpy(), np.asarray(jl), **RT)
    with pytest.raises(ValueError):
        prj.project(x, grad=True)
    with pytest.raises(ValueError):
        tbc.coresets.blackbox_family(None, 9, None, warm_sampler=lambda *a: None)


def test_warm_family_threads_its_carry():
    calls = []

    def warm(g, n, w, p, carry):
        calls.append(int(carry))
        return torch.zeros((n, 2)), carry + 1

    fam = tbc.coresets.blackbox_family(None, 3, lambda p, t: p @ t.T,
                                       warm_sampler=warm, init_carry=lambda w, p: torch.tensor(5))
    c = fam.init_carry(None, None)
    for _ in range(3):
        _, c = fam.make_ctx_warm(None, None, None, c)
    assert calls == [5, 6, 7]


@pytest.mark.parametrize("identity", [False, True])
def test_gaussian_tangent_family_matches_jax(identity):
    mu0, S0i, Si, x, w, _ = _setup(5, identity)
    LSi = np.linalg.cholesky(Si).astype(np.float32)
    jfam = jbc.coresets.gaussian_tangent_family(*_j(mu0, S0i, Si, LSi))
    jb = jg.posterior_basis(*_j(mu0, S0i, Si))
    carried = interop.posterior_basis(type(jb)(*map(np.asarray, jb)))
    pts, wc = x[:7], w[:7]
    jctx = jfam.make_ctx(None, *_j(wc, pts))
    jf = np.asarray(jfam.project(jctx, jnp.asarray(x)))
    jgr = np.asarray(jfam.project_grad(jctx, jnp.asarray(pts)))
    for basis in (carried, None):
        tfam = tbc.gaussian_tangent_family(*_t(mu0, S0i, Si, LSi), basis=basis)
        ctx = tfam.make_ctx(None, *_t(wc, pts))
        f = tfam.project(ctx, torch.as_tensor(x))
        gr = tfam.project_grad(ctx, torch.as_tensor(pts))
        assert f.shape == (x.shape[0], D + 1) and gr.shape == (7, D + 1, D)
        np.testing.assert_allclose((f @ f.T).numpy(), jf @ jf.T, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(torch.einsum("nsi,msj->nmij", gr, gr).numpy(),
                                   np.einsum("nsi,msj->nmij", jgr, jgr), rtol=1e-4, atol=1e-4)
        if basis is not None:
            np.testing.assert_allclose(f.numpy(), jf, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(gr.numpy(), jgr, rtol=1e-5, atol=1e-5)
    ident = tbc.identity_tangent_family()
    np.testing.assert_array_equal(ident.project(ident.make_ctx(None, None, None),
                                                torch.as_tensor(x[0])).numpy(), x[:1])


def _lr_data(seed=0, n=50, d=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-x @ np.full(d, 1.5))), 1.0, -1.0)
    return (y[:, None] * x).astype(np.float32), rng.normal(size=(7, d)).astype(np.float32)


def test_logistic_extras_match_jax():
    z, th = _lr_data()
    w = np.random.default_rng(1).uniform(0, 2, size=z.shape[0]).astype(np.float32)
    np.testing.assert_allclose(tlr.grad_z_log_likelihood(*_t(z, th)).numpy(),
                               np.asarray(jlr.grad_z_log_likelihood(*_j(z, th))), **RT)
    np.testing.assert_allclose(tlr.hess_th_log_likelihood(*_t(z, th)).numpy(),
                               np.asarray(jlr.hess_th_log_likelihood(*_j(z, th))), **RT)
    np.testing.assert_allclose(tlr.diag_hess_th_log_joint(*_t(z, th, w)).numpy(),
                               np.asarray(jlr.diag_hess_th_log_joint(*_j(z, th, w))),
                               rtol=1e-5, atol=1e-4)
    full = tlr.hess_th_log_joint(*_t(z, th, w))
    np.testing.assert_allclose(torch.diagonal(full, dim1=1, dim2=2).numpy(),
                               tlr.diag_hess_th_log_joint(*_t(z, th, w)).numpy(), rtol=1e-5)


def test_laplace_diag_mode_matches_jax():
    z, _ = _lr_data(2, n=200)
    w = np.ones(z.shape[0], np.float32)
    d = z.shape[1]
    j = jlap.laplace_approx(jnp.asarray(z), jnp.asarray(w), jnp.zeros(d),
                            grad_fn=jlr.grad_th_log_joint, hess_fn=jlr.diag_hess_th_log_joint,
                            diag=True)
    t = tlap.laplace_approx(torch.as_tensor(z), torch.as_tensor(w), torch.zeros(d),
                            grad_fn=tlr.grad_th_log_joint, hess_fn=tlr.diag_hess_th_log_joint,
                            diag=True)
    for a, b in zip(t, j):
        assert a.shape == (d,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    s = tlap.sample_laplace(torch.Generator().manual_seed(0), t, 50000, diag=True)
    np.testing.assert_allclose(s.std(dim=0).numpy(), t.USig.numpy(), rtol=0.02)
    np.testing.assert_allclose(s.mean(dim=0).numpy(), t.mu.numpy(), atol=0.03 * float(t.USig.max()))
    js = jlap.sample_laplace(jax.random.key(0), j, 50000, diag=True)
    np.testing.assert_allclose(np.asarray(js).std(axis=0), s.std(dim=0).numpy(), rtol=0.03)
