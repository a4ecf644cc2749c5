"""Weighted NUTS of the PyTorch port against the JAX package.

Deterministic pieces run both packages on the same numpy inputs and agree to
f32 rounding (rtol 1e-5; integers and schedules exactly).  One NUTS and one
HMC transition are held against the JAX kernels by giving the port's kernels
a draw source that replays, role by role, the draws ``jax.random`` makes
from the same keys; the new state must match (depth and step counts
exactly).  Whole runs are compared in distribution, against closed forms as
the JAX package's own tests do (tests/test_mcmc.py), at sizes small enough
for one CPU core.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.mcmc import adapt as jad
from bayesian_coresets_tpu.mcmc import diagnostics as jdg
from bayesian_coresets_tpu.mcmc import hmc as jhmc
from bayesian_coresets_tpu.mcmc import integrators as jint
from bayesian_coresets_tpu.mcmc import nuts as jnuts
from bayesian_coresets_tpu.mcmc import weighted as jw
from bayesian_coresets_tpu.models import logistic as jlr
from bayesian_coresets_tpu_torch import mcmc
from bayesian_coresets_tpu_torch.mcmc import adapt as tad
from bayesian_coresets_tpu_torch.mcmc import hmc as thmc
from bayesian_coresets_tpu_torch.mcmc import integrators as tint
from bayesian_coresets_tpu_torch.mcmc import nuts as tnuts
from bayesian_coresets_tpu_torch.mcmc import weighted as tw
from bayesian_coresets_tpu_torch.models import logistic as tlr
from bayesian_coresets_tpu_torch.utils import interop

torch.set_num_threads(1)

RTOL = 1e-5
C, D, N = 3, 4, 30


def _close(t, j, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def _t(x):
    return torch.as_tensor(np.array(x))


def _data(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, size=n).astype(np.float32)
    ref = (0.3 * rng.normal(size=d)).astype(np.float32)
    return z, w, ref


def _metric(kind, seed=1, c=C, d=D):
    """Per-chain inverse mass: (c, d) diagonal or (c, d, d) dense."""
    rng = np.random.default_rng(seed)
    if kind == "diag":
        return rng.uniform(0.5, 1.5, size=(c, d)).astype(np.float32)
    a = rng.normal(size=(c, d, d)).astype(np.float32) * 0.3
    return (np.einsum("cij,ckj->cik", a, a) + np.eye(d, dtype=np.float32)).astype(np.float32)


class JaxDraws:
    """Replays the draws of the JAX kernels from one key per chain.

    ``kind`` names whose keys: "nuts" (nuts.py:493, 503, 428: km for the
    momentum; per doubling kd, ks, kb; per leaf ku split from ks, the
    port asking for a doubling's leaves at once), "hmc"
    (hmc.py:35: km, ka, kj), or "direct" (adapt.find_reasonable_step_size
    draws the momentum from its key as it is)."""

    def __init__(self, keys, kind):
        self.keys, self.kind = list(keys), kind
        self.ks, self.kb = [None] * len(self.keys), [None] * len(self.keys)

    def _stack(self, xs, device):
        return torch.as_tensor(np.stack([np.asarray(x) for x in xs])).to(device)

    def momentum(self, shape, dtype, device):
        out = []
        for c, key in enumerate(self.keys):
            if self.kind == "nuts":
                key, km = jax.random.split(key)
                self.keys[c] = key
            elif self.kind == "hmc":
                km = jax.random.split(key, 3)[0]
            else:
                km = key
            out.append(jax.random.normal(km, shape[1:], jnp.float32))
        return self._stack(out, device)

    def direction(self, n, device):
        out = []
        for c, key in enumerate(self.keys):
            key, kd, self.ks[c], self.kb[c] = jax.random.split(key, 4)
            self.keys[c] = key
            out.append(jax.random.bernoulli(kd))
        return self._stack(out, device)

    def leaf_uniforms(self, L, n, device):
        """(L, n): row k the uniform of leaf k, from L successive splits of
        each chain's ks (the JAX kernel splits ks once per leaf it takes)."""
        out = []
        for c in range(n):
            row = []
            for _ in range(L):
                self.ks[c], ku = jax.random.split(self.ks[c])
                row.append(jax.random.uniform(ku))
            out.append(np.stack([np.asarray(x) for x in row]))
        return self._stack(out, device).T.contiguous()

    def tree_uniform(self, n, device):
        return self._stack([jax.random.uniform(kb) for kb in self.kb], device)

    def accept_uniform(self, n, device):
        return self._stack([jax.random.uniform(jax.random.split(k, 3)[1]) for k in self.keys],
                           device)

    def num_steps(self, n, high, device):
        return self._stack([jax.random.randint(jax.random.split(k, 3)[2], (), 1, high + 1)
                            for k in self.keys], device)


def _densities(seed=0):
    """The weighted logistic relative density in both packages, and
    value-and-grad functions (JAX per chain, the port batched)."""
    z, w, ref = _data(seed)
    jld = jw.weighted_logdensity(jlr, jnp.asarray(z), jnp.asarray(w), ref=jnp.asarray(ref))
    tld = tw.weighted_logdensity(tlr, _t(z), _t(w), ref=_t(ref))
    return jax.value_and_grad(jld), tint.value_and_grad(tld)


def _start(jvg, seed=2):
    z = (0.5 * np.random.default_rng(seed).normal(size=(C, D))).astype(np.float32)
    lp, g = jax.jit(jax.vmap(jvg))(jnp.asarray(z))
    return z, np.asarray(lp), np.asarray(g)


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("scale", [0.3, 10.0, 60.0])
def test_softplus_diff_values_and_grads(scale):
    """Both branches: |d| < 30 (stable form, d <= -17 included at scale 10)
    and |d| > 30 (direct difference); gradients finite everywhere."""
    rng = np.random.default_rng(0)
    p = (scale * rng.normal(size=200)).astype(np.float32)
    q = (scale * rng.normal(size=200)).astype(np.float32)
    if scale == 10.0:
        q = (p + rng.uniform(17.0, 29.0, size=200)).astype(np.float32)     # d in [-29, -17]
    jf = lambda a, b: jnp.sum(jlr._softplus_diff(a, b))  # noqa: E731
    jv = jax.jit(jlr._softplus_diff)(jnp.asarray(p), jnp.asarray(q))
    jgp, jgq = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(p), jnp.asarray(q))
    tp, tq = _t(p).requires_grad_(True), _t(q).requires_grad_(True)
    tv = tlr._softplus_diff(tp, tq)
    gp, gq = torch.autograd.grad(tv.sum(), (tp, tq))
    assert torch.isfinite(tv).all() and torch.isfinite(gp).all() and torch.isfinite(gq).all()
    _close(tv.detach(), jv)
    _close(gp, jgp)
    _close(gq, jgq)


def test_log_likelihood_diff_values_and_grads():
    z, _, ref = _data()
    th = (2.0 * np.random.default_rng(3).normal(size=(5, D))).astype(np.float32)
    jv = jax.jit(jlr.log_likelihood_diff)(jnp.asarray(z), jnp.asarray(th), jnp.asarray(ref))
    jg = jax.jit(jax.grad(lambda t: jnp.sum(jlr.log_likelihood_diff(
        jnp.asarray(z), t, jnp.asarray(ref)))))(jnp.asarray(th))
    tt = _t(th).requires_grad_(True)
    tv = tlr.log_likelihood_diff(_t(z), tt, _t(ref))
    (tg,) = torch.autograd.grad(tv.sum(), tt)
    _close(tv.detach(), jv)
    _close(tg, jg)


# ----------------------------------------------------------- integrators


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_integrator_pieces_match(kind):
    jvg, tvg = _densities()
    z, lp, g = _start(jvg)
    im = _metric(kind)
    r = np.random.default_rng(4).normal(size=(C, D)).astype(np.float32)
    step = np.float32(0.17)
    # mass_mul and kinetic, per chain
    jmm, jk = jax.jit(jax.vmap(lambda im, r: (jint.mass_mul(im, r), jint.kinetic(r, im))))(
        jnp.asarray(im), jnp.asarray(r))
    _close(tint.mass_mul(_t(im), _t(r)), jmm)
    _close(tint.kinetic(_t(r), _t(im)), jk)
    # leapfrog from the same state
    js = jax.jit(jax.vmap(lambda z, r, lp, g, im: jint.leapfrog(
        jvg, jint.IntegratorState(z, r, lp, g), step, im)))(
        *map(jnp.asarray, (z, r, lp, g, im)))
    ts = tint.leapfrog(tvg, tint.IntegratorState(_t(z), _t(r), _t(lp), _t(g)), float(step), _t(im))
    for a, b in zip(ts, js):
        _close(a, b)
    # momentum from the same normal draws
    keys = jax.random.split(jax.random.key(5), C)
    jr = jax.jit(jax.vmap(lambda k, im: jint.sample_momentum(k, im, (D,), jnp.float32)))(
        keys, jnp.asarray(im))
    tr = tint.sample_momentum(JaxDraws(keys, "direct"), _t(im), (C, D), torch.float32)
    _close(tr, jr)


# ------------------------------------------------------------- adaptation


def test_dual_averaging_matches():
    acc = np.random.default_rng(0).uniform(size=(25, C)).astype(np.float32)
    steps = np.array([0.3, 1.0, 2.5], np.float32)
    js = jax.vmap(jad.da_init)(jnp.asarray(steps))
    ts = tad.da_init(_t(steps))
    update = jax.jit(jax.vmap(lambda s, a: jad.da_update(s, a, target=0.8)))
    for a in acc:
        js = update(js, jnp.asarray(a))
        ts = tad.da_update(ts, _t(a), target=0.8)
    for a, b in zip(ts, js):
        _close(a, b)


@pytest.mark.parametrize("dense", [False, True])
def test_welford_matches(dense):
    xs = np.random.default_rng(0).normal(size=(40, C, D)).astype(np.float32)
    xs[..., 1] += 2.0 * xs[..., 0]
    # single updates, one state per chain
    jwf = jax.vmap(lambda _: jad.welford_init(D, dense=dense))(jnp.arange(C))
    twf = tad.welford_init(D, dense=dense, batch=(C,))
    update = jax.jit(jax.vmap(jad.welford_update))
    for x in xs:
        jwf = update(jwf, jnp.asarray(x))
        twf = tad.welford_update(twf, _t(x))
    for a, b in zip(twf, jwf):
        _close(a, b)
    _close(tad.welford_variance(twf), jax.vmap(jad.welford_variance)(jwf))
    # batch (Chan) merges of every chain's positions into one state
    jb, tb = jad.welford_init(D, dense=dense), tad.welford_init(D, dense=dense)
    update_batch = jax.jit(jad.welford_update_batch)
    for x in xs:
        jb = update_batch(jb, jnp.asarray(x))
        tb = tad.welford_update_batch(tb, _t(x))
    for a, b in zip(tb, jb):
        _close(a, b, rtol=2e-5)
    _close(tad.welford_variance(tb), jad.welford_variance(jb), rtol=2e-5)


@pytest.mark.parametrize("num_warmup", [0, 20, 149, 150, 200, 500, 1000, 1234])
def test_build_segments_equal(num_warmup):
    assert tad.build_segments(num_warmup) == jad.build_segments(num_warmup)
    for a, b in zip(tad.build_schedule(num_warmup), jad.build_schedule(num_warmup)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("init_step", [1.0, 0.01])
def test_find_reasonable_step_size_matches(init_step):
    jvg, tvg = _densities()
    z, lp, g = _start(jvg)
    im = _metric("diag")
    keys = jax.random.split(jax.random.key(7), C)
    js = jax.jit(jax.vmap(lambda k, z, lp, g, im: jad.find_reasonable_step_size(
        jvg, z, lp, g, im, k, init_step=init_step)))(keys, *map(jnp.asarray, (z, lp, g, im)))
    ts = tad.find_reasonable_step_size(tvg, _t(z), _t(lp), _t(g), _t(im),
                                       JaxDraws(keys, "direct"), init_step=init_step)
    _close(ts, js)


# ------------------------------------------------------------- diagnostics


def test_diagnostics_match():
    rng = np.random.default_rng(0)
    x = np.zeros((4, 300, 3), np.float32)
    for t in range(1, 300):                     # AR(1) chains, some autocorrelation
        x[:, t] = 0.6 * x[:, t - 1] + rng.normal(size=(4, 3))
    x += np.array([0.0, 0.1, -0.2], np.float32)[None, None, :] * np.arange(4)[:, None, None]
    _close(mcmc.split_rhat(_t(x)), jax.jit(jdg.split_rhat)(jnp.asarray(x)))
    _close(mcmc.ess(_t(x)), jax.jit(jdg.ess)(jnp.asarray(x)))
    _close(mcmc.ess(_t(x), max_lag=31),
           jax.jit(jdg.ess, static_argnums=1)(jnp.asarray(x), 31))


# ------------------------------------------------------ weighted densities


@pytest.mark.parametrize("form", ["absolute", "relative_diff", "relative_ll"])
def test_weighted_logdensity_matches(form):
    z, w, ref = _data()
    jm, tm = jlr, tlr
    if form == "relative_ll":                   # a model without log_likelihood_diff
        jm = types.SimpleNamespace(log_likelihood=jlr.log_likelihood, log_prior=jlr.log_prior,
                                   log_joint=jlr.log_joint)
        tm = types.SimpleNamespace(log_likelihood=tlr.log_likelihood, log_prior=tlr.log_prior,
                                   log_joint=tlr.log_joint)
    r = None if form == "absolute" else ref
    jld = jw.weighted_logdensity(jm, jnp.asarray(z), jnp.asarray(w),
                                 ref=None if r is None else jnp.asarray(r))
    tld = tw.weighted_logdensity(tm, _t(z), _t(w), ref=None if r is None else _t(r))
    th = np.random.default_rng(8).normal(size=(5, D)).astype(np.float32)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jld)))(jnp.asarray(th))
    tv, tg = tint.value_and_grad(tld)(_t(th))
    _close(tv, jv)
    _close(tg, jg)


# --------------------------------------------------- one transition each


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_one_nuts_transition_matches(kind):
    """Three chains in one batched transition against the vmapped JAX
    kernel on replayed draws: every chain's new z, logp, grad (rtol 1e-5),
    depth and leapfrog count (exactly)."""
    jvg, tvg = _densities()
    z, lp, g = _start(jvg)
    im = _metric(kind)
    steps = np.array([0.05, 0.3, 0.8], np.float32)   # deep, middling and shallow trees
    keys = jax.random.split(jax.random.key(11), C)
    jst, jinfo = jax.jit(jax.vmap(lambda k, z, lp, g, st, im: jnuts.nuts_kernel(
        jvg, k, jint.IntegratorState(z, jnp.zeros_like(z), lp, g), st, im, max_depth=6)))(
        keys, *map(jnp.asarray, (z, lp, g, steps, im)))
    tst, tinfo = tnuts.nuts_kernel(tvg, JaxDraws(keys, "nuts"),
                                   tint.IntegratorState(_t(z), torch.zeros(C, D), _t(lp), _t(g)),
                                   _t(steps), _t(im), max_depth=6)
    np.testing.assert_array_equal(tinfo.depth.numpy(), np.asarray(jinfo.depth))
    np.testing.assert_array_equal(tinfo.num_steps.numpy(), np.asarray(jinfo.num_steps))
    np.testing.assert_array_equal(tinfo.diverging.numpy(), np.asarray(jinfo.diverging))
    assert len(set(tinfo.depth.tolist())) > 1          # the chains' trees differ in depth
    for a, b in zip(tst, jst):
        _close(a, b)
    _close(tinfo.accept_prob, jinfo.accept_prob)
    # the port's own state type carries over from the JAX arrays
    back = interop.integrator_state(type(jst)(*map(np.asarray, jst)))
    for a, b in zip(back, tst):
        _close(a, b)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_one_hmc_transition_matches(kind):
    jvg, tvg = _densities()
    z, lp, g = _start(jvg)
    im = _metric(kind)
    keys = jax.random.split(jax.random.key(12), C)
    # eager vmap: XLA's fusion under jit rounds a 12-step trajectory's last
    # gradient differently, at ~3e-5 relative on its smallest entry
    jst, jinfo = jax.vmap(lambda k, z, lp, g, im: jhmc.hmc_kernel(
        jvg, k, jint.IntegratorState(z, jnp.zeros_like(z), lp, g), 0.2, im, num_steps=12))(
        keys, *map(jnp.asarray, (z, lp, g, im)))
    tst, tinfo = thmc.hmc_kernel(tvg, JaxDraws(keys, "hmc"),
                                 tint.IntegratorState(_t(z), torch.zeros(C, D), _t(lp), _t(g)),
                                 0.2, _t(im), num_steps=12)
    np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
    for a, b in zip(tst, jst):
        _close(a, b)
    _close(tinfo.accept_prob, jinfo.accept_prob)


# --------------------------------------------------------- in distribution

COV = torch.tensor([[2.0, 1.2], [1.2, 1.5]])


def _gauss_logp(cov):
    prec = torch.linalg.inv(cov)
    return lambda th: -0.5 * torch.sum((th @ prec) * th, dim=-1)


@pytest.fixture(scope="module")
def gauss_res():
    return mcmc.run_nuts(_gauss_logp(COV), torch.zeros((16, 2)), torch.Generator().manual_seed(0),
                         num_warmup=200, num_samples=250)


class TestNUTS:
    def test_gaussian_moments(self, gauss_res):
        s = gauss_res.samples.reshape(-1, 2).numpy()
        np.testing.assert_allclose(s.mean(0), np.zeros(2), atol=0.15)
        np.testing.assert_allclose(np.cov(s, rowvar=False), COV.numpy(), rtol=0.15, atol=0.1)

    def test_adaptation_hits_target(self, gauss_res):
        acc = gauss_res.accept_prob.numpy()
        assert (acc > 0.6).all() and (acc <= 1.0).all()
        assert (gauss_res.num_divergent.numpy() == 0).all()
        assert gauss_res.step_size.shape == (16,) and gauss_res.inv_mass.shape == (16, 2)
        assert ((gauss_res.tree_depth >= 1) & (gauss_res.tree_depth <= 10)).all()

    def test_diagnostics(self, gauss_res):
        assert (mcmc.split_rhat(gauss_res.samples) < 1.05).all()
        assert (mcmc.ess(gauss_res.samples) > 200).all()

    def test_deterministic_given_generator(self):
        logp = lambda th: -0.5 * torch.sum(th**2, dim=-1)  # noqa: E731
        r1, r2 = (mcmc.run_nuts(logp, torch.zeros((2, 3)), torch.Generator().manual_seed(7),
                                num_warmup=30, num_samples=30) for _ in range(2))
        np.testing.assert_array_equal(r1.samples.numpy(), r2.samples.numpy())

    def test_max_depth_bounds_steps(self):
        # a tiny step forces deep trees; num_steps must stay < 2^depth
        vg = tint.value_and_grad(lambda th: -0.5 * torch.sum(th**2, dim=-1))
        z = torch.ones((2, 2))
        lp, g = vg(z)
        _, info = tnuts.nuts_kernel(vg, torch.Generator().manual_seed(0),
                                    tint.IntegratorState(z, torch.zeros(2, 2), lp, g), 1e-4,
                                    torch.ones(2, 2), max_depth=6)
        assert (info.num_steps <= 2**6).all() and (info.depth <= 6).all()


class TestWeightedParity:
    def setup_method(self):
        self.z = tlr.gen_synthetic(torch.Generator().manual_seed(1), 20, 3, theta_scale=1.0)
        self.w = torch.as_tensor(np.random.default_rng(0).integers(0, 4, 20), dtype=torch.float32)
        self.z_rep = torch.as_tensor(np.repeat(self.z.numpy(), self.w.numpy().astype(int), axis=0))

    def test_logdensity_equal(self):
        ld_w = tw.weighted_logdensity(tlr, self.z, self.w)
        ld_r = tw.weighted_logdensity(tlr, self.z_rep, torch.ones(self.z_rep.shape[0]))
        t = torch.randn((5, 3), generator=torch.Generator().manual_seed(2))
        a, b = ld_w(t), ld_r(t)
        assert (torch.abs(a - b) < 1e-3 * torch.abs(b) + 1e-3).all()

    def test_posterior_moments_equal(self):
        ld_w = tw.weighted_logdensity(tlr, self.z, self.w)
        ld_r = tw.weighted_logdensity(tlr, self.z_rep, torch.ones(self.z_rep.shape[0]))
        rw = mcmc.run_nuts(ld_w, torch.zeros((12, 3)), torch.Generator().manual_seed(5),
                           num_warmup=100, num_samples=150)
        rr = mcmc.run_nuts(ld_r, torch.zeros((12, 3)), torch.Generator().manual_seed(6),
                           num_warmup=100, num_samples=150)
        sw, sr = rw.samples.reshape(-1, 3).numpy(), rr.samples.reshape(-1, 3).numpy()
        np.testing.assert_allclose(sw.mean(0), sr.mean(0), atol=0.1)
        np.testing.assert_allclose(np.cov(sw, rowvar=False), np.cov(sr, rowvar=False), atol=0.1)

    def test_zero_weights_drop_data(self):
        w0 = self.w.clone()
        w0[:10] = 0.0
        ld = tw.weighted_logdensity(tlr, self.z, w0)
        ld_sub = tw.weighted_logdensity(tlr, self.z[10:], w0[10:])
        t = torch.tensor([[0.3, -0.2, 0.8]])
        assert abs(float(ld(t)[0]) - float(ld_sub(t)[0])) < 1e-4


class TestHMC:
    def test_gaussian_moments(self):
        prec = torch.tensor([[1.0, 0.0], [0.0, 4.0]])
        vg = tint.value_and_grad(lambda th: -0.5 * torch.sum((th @ prec) * th, dim=-1))
        z = torch.zeros((16, 2))
        st = tint.IntegratorState(z, torch.zeros_like(z), *vg(z))
        gen, zs = torch.Generator().manual_seed(0), []
        for i in range(300):
            st, _ = thmc.hmc_kernel(vg, gen, st, 0.2, torch.ones(16, 2), num_steps=16)
            if i >= 50:
                zs.append(st.z)
        zs = torch.cat(zs).numpy()
        np.testing.assert_allclose(zs.mean(0), np.zeros(2), atol=0.1)
        np.testing.assert_allclose(np.cov(zs, rowvar=False), np.linalg.inv(prec.numpy()),
                                   rtol=0.2, atol=0.05)


class TestPooledAdaptation:
    def test_pooled_moments_and_shared_step(self):
        res = mcmc.run_nuts(_gauss_logp(COV), torch.zeros((16, 2)), torch.Generator().manual_seed(0),
                            num_warmup=200, num_samples=250, pooled_adaptation=True)
        s = res.samples.reshape(-1, 2).numpy()
        np.testing.assert_allclose(np.cov(s, rowvar=False), COV.numpy(), rtol=0.15, atol=0.1)
        # one shared step size and metric across chains
        assert np.unique(res.step_size.numpy()).size == 1
        assert (res.inv_mass == res.inv_mass[0]).all()
        assert (res.accept_prob > 0.5).all()

    def test_pooled_step_seed_is_the_median(self):
        """An even chain count averages the two middle steps, as jnp.median
        does (torch.median would return the lower one)."""
        steps = torch.tensor([0.5, 4.0, 1.0, 2.0])
        assert float(torch.quantile(steps, 0.5)) == float(jnp.median(jnp.asarray(steps.numpy())))


class TestRunWrapper:
    def test_reference_conventions(self):
        z = tlr.gen_synthetic(torch.Generator().manual_seed(0), 50, 2, theta_scale=1.0)
        samples, t, res = tw.run(tlr, z, torch.ones(50), 60, torch.Generator().manual_seed(1),
                                 num_chains=2)
        assert samples.shape == (120, 2)            # chains * n_samples, d
        assert t > 0 and torch.isfinite(samples).all()
        assert res.samples.shape == (2, 60, 2)

    def test_mesh_is_rejected(self):
        """``mesh=`` takes a ``parallel.make_mesh`` mesh (chains sharded over
        ranks, tests/test_torch_parallel.py) and refuses anything else."""
        z = tlr.gen_synthetic(torch.Generator().manual_seed(0), 10, 2)
        with pytest.raises(ValueError, match="parallel.make_mesh"):
            tw.run(tlr, z, torch.ones(10), 5, torch.Generator(), mesh=object())

    def test_f64_logdensity_island(self):
        """The density and its gradient in f64; samples, states and the
        metric stay f32, and each posterior mean lies within 0.25 posterior
        sd of the Laplace mode."""
        z = tlr.gen_synthetic(torch.Generator().manual_seed(3), 60, 2, theta_scale=1.0)
        s64, _, r64 = tw.run(tlr, z, torch.ones(60), 100, torch.Generator().manual_seed(4),
                             num_chains=8, num_warmup=150, f64_logdensity=True)
        assert s64.dtype == torch.float32 and r64.inv_mass.dtype == torch.float32
        mode = tw.fit_laplace(tlr, z, torch.ones(60), 2).mu
        assert (torch.abs(s64.mean(dim=0) - mode) < 0.25 * s64.std(dim=0)).all()


def test_laplace_init_and_fallback():
    Z = tlr.gen_synthetic(torch.Generator().manual_seed(0), 50, 4)
    w = torch.full((50,), 100.0)
    init = tw.laplace_init(tlr, Z, w, 8, torch.Generator().manual_seed(1), 4)
    assert init.shape == (8, 4)
    assert not np.allclose(init.numpy(), 0.0)          # near the mode, not 0
    assert init.std(dim=0).max() < 1.0                  # overdispersed but local
    bare = types.SimpleNamespace(log_joint=tlr.log_joint)
    init0 = tw.laplace_init(bare, Z, w, 3, torch.Generator().manual_seed(1), 4)
    np.testing.assert_array_equal(init0.numpy(), np.zeros((3, 4)))


class TestPoisonedStateRobustness:
    """A state with a non-finite cached gradient must never poison the
    sampler (one such chain collapsed a pooled step size on airportdelays)."""

    def test_step_size_search_falls_back_on_poisoned_state(self):
        vg = tint.value_and_grad(lambda x: -0.5 * torch.sum(x**2, dim=-1))
        z = torch.zeros((2, 4))
        logp, grad = vg(z)
        grad[0, 0] = float("inf")                       # chain 0 poisoned, chain 1 clean
        step = tad.find_reasonable_step_size(vg, z, logp, grad, torch.ones(2, 4),
                                             torch.Generator().manual_seed(0), init_step=0.37)
        assert abs(float(step[0]) - 0.37) < 1e-6
        assert abs(float(step[1]) - 0.37) > 1e-3

    def test_nuts_never_caches_nonfinite_grad(self):
        class LogD(torch.autograd.Function):
            # finite logp everywhere, but the gradient overflows beyond |x0| > 1.5
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return -0.5 * torch.sum(x**2, dim=-1)

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensors
                bad = torch.where(torch.abs(x[:, :1]) > 1.5, float("inf"), 1.0)
                return g[:, None] * (-x * bad)

        vg = tint.value_and_grad(LogD.apply)
        z = torch.zeros((4, 3))
        st = tint.IntegratorState(z, torch.zeros_like(z), *vg(z))
        gen = torch.Generator().manual_seed(1)
        for _ in range(120):
            st, _ = tnuts.nuts_kernel(vg, gen, st, 0.6, torch.ones(4, 3), 6)
            assert torch.isfinite(st.grad).all() and torch.isfinite(st.logp).all()


class TestDenseMass:
    def test_correlated_gaussian_recovers_full_covariance(self):
        rho = 0.99
        cov = torch.tensor([[1.0, rho, 0.0], [rho, 1.0, 0.0], [0.0, 0.0, 4.0]])
        res = mcmc.run_nuts(_gauss_logp(cov), torch.zeros((16, 3)), torch.Generator().manual_seed(0),
                            num_warmup=200, num_samples=200, dense_mass=True)
        assert res.inv_mass.shape == (16, 3, 3)
        assert res.inv_mass_diag is res.inv_mass
        got = np.cov(res.samples.reshape(-1, 3).numpy(), rowvar=False)
        np.testing.assert_allclose(got, cov.numpy(), rtol=0.2, atol=0.15)
        im = res.inv_mass[0]
        assert im[0, 1] / torch.sqrt(im[0, 0] * im[1, 1]) > 0.9
        assert (mcmc.split_rhat(res.samples) < 1.05).all()

    def test_pooled_dense(self):
        cov = torch.tensor([[1.0, 0.95], [0.95, 1.0]])
        res = mcmc.run_nuts(_gauss_logp(cov), torch.zeros((8, 2)), torch.Generator().manual_seed(3),
                            num_warmup=200, num_samples=200, dense_mass=True,
                            pooled_adaptation=True)
        assert res.inv_mass.shape == (8, 2, 2)
        s = res.samples.reshape(-1, 2).numpy()
        np.testing.assert_allclose(np.cov(s, rowvar=False), cov.numpy(), rtol=0.2, atol=0.15)

    def test_hmc_kernel_dense_metric(self):
        cov = torch.tensor([[1.0, 0.9], [0.9, 1.0]])
        vg = tint.value_and_grad(_gauss_logp(cov))
        z = torch.zeros((16, 2))
        st = tint.IntegratorState(z, torch.zeros_like(z), *vg(z))
        inv_mass = cov.expand(16, 2, 2)                 # the exact metric
        gen, zs, acc = torch.Generator().manual_seed(0), [], []
        for i in range(250):
            st, info = thmc.hmc_kernel(vg, gen, st, 0.5, inv_mass, num_steps=8)
            if i >= 50:
                zs.append(st.z)
                acc.append(info.accept_prob)
        assert float(torch.cat(acc).mean()) > 0.8
        np.testing.assert_allclose(np.cov(torch.cat(zs).numpy().T), cov.numpy(),
                                   rtol=0.25, atol=0.15)

    def test_weighted_run_dense_mass(self):
        # end to end through mcmc.run on a weighted logistic posterior: the
        # dense metric is a sampler control, not a model change, so the
        # posterior means sit at the Laplace mode within 0.25 posterior sd
        rng = np.random.default_rng(0)
        x = rng.normal(size=(40, 2)).astype(np.float32)
        y = np.sign(x[:, 0] + 0.5 * x[:, 1] + 0.1).astype(np.float32)
        z = torch.as_tensor(np.concatenate([x * y[:, None], y[:, None]], axis=1))
        s, _, res = tw.run(tlr, z, torch.ones(40), 80, torch.Generator().manual_seed(1),
                           num_chains=8, num_warmup=150, dense_mass=True)
        assert res.inv_mass.shape == (8, 3, 3)
        mode = tw.fit_laplace(tlr, z, torch.ones(40), 3).mu
        assert (torch.abs(s.mean(dim=0) - mode) < 0.25 * s.std(dim=0)).all()


def test_mcmc_result_from_jax_arrays():
    """MCMCResult carries over from the JAX package's numpy fields."""
    rng = np.random.default_rng(0)
    jr = types.SimpleNamespace(samples=rng.normal(size=(2, 5, 3)).astype(np.float32),
                               accept_prob=np.ones(2, np.float32), num_divergent=np.zeros(2, np.int32),
                               step_size=np.full(2, 0.5, np.float32),
                               inv_mass=np.ones((2, 3), np.float32))
    r = interop.mcmc_result(jr)
    assert isinstance(r, mcmc.MCMCResult) and r.tree_depth is None
    np.testing.assert_array_equal(r.samples.numpy(), jr.samples)
    _close(mcmc.split_rhat(r.samples), jdg.split_rhat(jnp.asarray(jr.samples)))
