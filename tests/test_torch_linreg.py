"""The port's linear-regression model and its exact tangent family against
the JAX package's, on numpy inputs made from a seed: f32 within rtol 1e-5,
atol 1e-6; the posterior refits (``weighted_post`` by QR,
``weighted_post_lowrank`` by a matrix square root of the (m, m) Gram, the
JAX package's by an eigh of it) within rtol 1e-4 on the mean, on the
covariance F F^T and on the symmetric factor F, since the factorizations
come from other routines on each side.  At the linear_regression driver's
width the low-rank refit is held in f64 to a numpy transcription of the
JAX package's eigh formula and to the QR posterior.
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


@pytest.mark.parametrize("m", [1, 3, 4, 12])
def test_weighted_post_lowrank_matches_jax(m):
    """m rows below, at and above the parameter dimension (full-rank and
    rank-deficient Grams); a zero weight among them (m = 1: the only one)."""
    z, _, w, th0, Sig0inv = _inputs(2, n=m)
    w[min(1, m - 1)] = 0.0
    tb = tl.lowrank_basis(*_t(th0, Sig0inv), SIGSQ)
    jb = jl.lowrank_basis(*_j(th0, Sig0inv), SIGSQ)
    for f in ("L0inv", "L0invT", "r0", "sigsq"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), **TOL)
    tmu, tF = tl.weighted_post_lowrank(tb, *_t(z, w))
    jmu, jF = jl.weighted_post_lowrank(jb, *_j(z, w))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **POST_TOL)
    np.testing.assert_allclose((tF @ tF.T).numpy(), np.asarray(jF @ jF.T), **POST_TOL)
    # the same symmetric factor L0^{-T} (I + W^T W)^{-1/2}, not another one
    np.testing.assert_allclose(tF.numpy(), np.asarray(jF), **POST_TOL)
    # and it is the QR posterior
    post = tl.weighted_post(*_t(th0, Sig0inv), SIGSQ, *_t(z, w))
    np.testing.assert_allclose(tmu.numpy(), post.mu.numpy(), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose((tF @ tF.T).numpy(), (post.USig @ post.USig.T).numpy(),
                               rtol=1e-3, atol=1e-6)


# The linear_regression driver's design (experiments/linear_regression.py:
# 66-87 at its defaults: 10000 synthetic housing rows, 6 x 50 RBF bases and a
# constant one, d = 301) and the refit's tolerances there, in f64:
# - F against the eigh formula, relative in the Frobenius norm: the formula
#   is itself off by up to ~1.4e-8 in F F^T from the QR posterior (its
#   V = W^T U / lam^{1/2} loses the small eigenvalues' directions), the
#   refit by 2.6e-10 (on a CPU);
# - F F^T against the QR posterior, largest entry's error over the largest
#   entry; the mean against the QR posterior's likewise (the eigh formula's
#   mean, t - V c V^T t, cancels: 1e-4 off, the refit's 1e-8);
# - the square root's residual |S^2 - A|_F / |A|_F.
WIDE_TOL = {"F_eigh": 2e-8, "Sig_qr": 2e-9, "mu_qr": 2e-7, "residual": 1e-9}


@pytest.fixture(scope="module")
def driver_design():
    from bayesian_coresets_tpu_torch.experiments import datasets
    rng = np.random.default_rng(0)
    x = datasets.gen_synthetic_housing(rng, 10000)
    sigsq, mn = x[:, 2].var(), x[:, 2].mean()
    counts = [50] * 6 + [1]
    scales = np.repeat([0.2, 0.4, 0.8, 1.2, 1.6, 2.0, 100.0], counts)
    locs = np.vstack([x[rng.choice(np.arange(x.shape[0]), replace=False, size=c), :2]
                      for c in counts])
    X = np.exp(-((x[:, None, :2] - locs[None]) ** 2).sum(-1) / (2.0 * scales[None] ** 2))
    Z = np.hstack((X, x[:, 2:])).astype(np.float32)
    d = X.shape[1]
    return Z, np.full(d, mn), np.eye(d) / (sigsq + mn**2), sigsq


def _eigh_refit_np(L0inv, L0invT, r0, sigsq, z, w):
    """The JAX package's weighted_post_lowrank (bayesian_coresets_tpu/models/
    linreg.py:142-162) in numpy f64, with its mask of the Gram's
    eigenvalues at 0: its threshold, 1e-7 of the largest, is f32's
    rounding, and in f64 it drops eigenvalues up to hundreds here."""
    x, y = z[:, :-1], z[:, -1]
    sw = np.sqrt(np.maximum(w, 0.0))
    W = (sw[:, None] * x) @ L0invT / np.sqrt(sigsq)
    G = W @ W.T
    lam, U = np.linalg.eigh(0.5 * (G + G.T))
    lam = np.maximum(lam, 0.0)
    mask = lam > 0.0
    lam_safe = np.where(mask, lam, 1.0)
    V = np.where(mask[None, :], (W.T @ U) / np.sqrt(lam_safe)[None, :], 0.0)
    c_inv = np.where(mask, lam / (1.0 + lam), 0.0)
    c_half = np.where(mask, 1.0 - 1.0 / np.sqrt(1.0 + lam), 0.0)
    t = L0inv @ (r0 + x.T @ (w * y) / sigsq)
    t = t - V @ (c_inv * (V.T @ t))
    return L0invT @ t, L0invT - ((L0invT @ V) * c_half[None, :]) @ V.T


def _qr_post_np(th0, Sig0inv, sigsq, z, w):
    """The weighted posterior's (mean, covariance) by QR of the stacked
    design, which never squares its conditioning."""
    x, y = z[:, :-1], z[:, -1]
    sw = np.sqrt(w)
    L0 = np.linalg.cholesky(Sig0inv)
    B = np.vstack([sw[:, None] * x / np.sqrt(sigsq), L0.T])
    Q, R = np.linalg.qr(B)
    Rinv = np.linalg.solve(R, np.eye(R.shape[0]))
    return Rinv @ (Q.T @ np.hstack([sw * y / np.sqrt(sigsq), L0.T @ th0])), Rinv @ Rinv.T


@pytest.mark.parametrize("m,weights", [(30, "uniform"), (300, "uniform"), (300, "decades"),
                                       (300, "decades_repeated_rows")])
def test_weighted_post_lowrank_at_the_drivers_width(driver_design, m, weights):
    """m = 300 slots against d = 301 bases, the driver's SparseVI capacity
    (and chip_smoke's 30): weights summing to about N, or spread over six
    decades with a tenth of the slots empty, or that with 20 slots
    repeating others' rows (an exactly rank-deficient Gram; the RBF design's
    own Gram is numerically so, its eigenvalues falling past 1e-16 of the
    largest, which is ~1e9 here)."""
    Z, th0, Sig0inv, sigsq = driver_design
    rng = np.random.default_rng(m + len(weights))
    z = Z[rng.choice(Z.shape[0], m, replace=False)].astype(np.float64)
    if weights == "uniform":
        w = rng.uniform(0.0, 2.0 * Z.shape[0] / m, m)
    else:
        w = 10.0 ** rng.uniform(-3.0, 3.0, m) * Z.shape[0] / (20.0 * m)
        w[rng.choice(m, m // 10, replace=False)] = 0.0
    if weights == "decades_repeated_rows":
        z[m // 2: m // 2 + 20] = z[:20]
    basis = tl.lowrank_basis(*_t(th0, Sig0inv), sigsq)
    mu, F, res = tl.weighted_post_lowrank(basis, *_t(z, w), residual=True)
    assert mu.dtype == F.dtype == res.dtype == torch.float64
    mu, F = mu.numpy(), F.numpy()
    mu_e, F_e = _eigh_refit_np(*(b.numpy() for b in basis[:3]), sigsq, z, w)
    mu_q, Sig_q = _qr_post_np(th0, Sig0inv, sigsq, z, w)
    err = {"F_eigh": np.linalg.norm(F - F_e) / np.linalg.norm(F_e),
           "Sig_qr": np.abs(F @ F.T - Sig_q).max() / np.abs(Sig_q).max(),
           "mu_qr": np.abs(mu - mu_q).max() / np.abs(mu_q).max(),
           "residual": float(res)}
    assert all(err[k] <= WIDE_TOL[k] for k in WIDE_TOL), err
    # the factor is the symmetric one: L0^T F is symmetric
    L0TF = np.linalg.cholesky(Sig0inv).T @ F
    assert np.abs(L0TF - L0TF.T).max() <= 1e-9 * np.abs(L0TF).max()


@pytest.mark.parametrize("spectrum", ["log_spread", "one_large", "half_empty"])
def test_sqrt_spd_converges_within_its_steps(spectrum):
    """The square root's SQRT_STEPS steps act on A's eigenvalues alone (its
    scale reads only their norms), so a diagonal A stands for every A with
    that spectrum: eigenvalues 1 + lam, lam up to 1e16, at m = 512 (the
    largest power-of-two capacity past d = 301 is 512), reach their square
    roots within f64 rounding; A's Cholesky factor comes back with S."""
    m = 512
    rng = np.random.default_rng(11)
    if spectrum == "log_spread":
        lam = 10.0 ** rng.uniform(-20.0, 16.0, m)
    elif spectrum == "one_large":
        lam = np.zeros(m)
    else:
        lam = np.where(np.arange(m) < m // 2, 10.0 ** rng.uniform(14.0, 16.0, m), 0.0)
    lam[0] = 1e16
    A = torch.diag(torch.as_tensor(1.0 + lam))
    S, L = tl._sqrt_spd(A)
    root = np.sqrt(1.0 + lam)
    assert np.abs(np.diag(S.numpy()) / root - 1.0).max() <= 1e-14
    assert float(torch.count_nonzero(S - torch.diag(torch.diagonal(S)))) == 0
    np.testing.assert_array_equal(np.diag(L.numpy()), root)


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
