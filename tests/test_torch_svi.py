"""SparseVI of the port against the JAX package.

- With the exact Gaussian tangent family and no subsampling, nothing is
  drawn at random, so the two builds are held step for step: at N=300,
  d=12, 32 select rounds of 20 Adam steps each add 22 atoms, and the
  selected index sequences are identical (checked at these sizes; an f32
  near-tie in the argmax could part them at others), with weights within
  rtol 1e-4 (f32 projections and matmuls summed in other orders).  The JAX
  basis is carried across: ``posterior_basis`` of the identity has no
  unique eigenbasis.
- Black-box builds draw from other streams (``torch.Generator`` against
  ``jax.random``), so they are held in distribution: over 9 seeds on each
  side, the port's median rKL lies within the spread of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_coresets_tpu as jbc
import bayesian_coresets_tpu_torch as tbc
from bayesian_coresets_tpu.coresets import sparsevi as jsv
from bayesian_coresets_tpu.models import gaussian as jg
from bayesian_coresets_tpu_torch.coresets import sparsevi as tsv
from bayesian_coresets_tpu_torch.models import gaussian as tg
from bayesian_coresets_tpu_torch.utils import config, interop

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


N, D, M, OPT, CAP = 300, 12, 32, 20, 32
SCHED = lambda i: 1.0 / (1.0 + i)   # noqa: E731


def _data(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    return (1.0 + rng.normal(size=(n, d))).astype(np.float32)


def _exact_families(d=D):
    mu0, eye = jnp.zeros(d), jnp.eye(d)
    jfam = jbc.coresets.gaussian_tangent_family(mu0, eye, eye, eye)
    jb = jg.posterior_basis(mu0, eye, eye)
    tb = interop.posterior_basis(type(jb)(*map(np.asarray, jb)))
    tfam = tbc.gaussian_tangent_family(torch.zeros(d), torch.eye(d), torch.eye(d),
                                       torch.eye(d), basis=tb)
    return jfam, tfam


def _exact_pair(seed=0):
    x = _data(seed)
    jfam, tfam = _exact_families()
    j = jbc.SparseVICoreset(jnp.asarray(x), jfam, opt_itrs=OPT, capacity=CAP)
    t = tbc.SparseVICoreset(torch.as_tensor(x), tfam, opt_itrs=OPT, capacity=CAP)
    return x, j, t


def test_exact_family_build_matches_jax_step_for_step():
    x, j, t = _exact_pair()
    j.build(M)
    t.build(M)
    jw, jp, ji = j.get()
    tw, tp, ti = t.get()
    assert ti.size >= 20
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tp, x[ti])
    assert (tw >= 0).all() and len(set(ti.tolist())) == ti.size
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)
    # svi_optimize from the same state
    j._optimize()
    t._optimize()
    np.testing.assert_allclose(t.get()[0], j.get()[0], rtol=1e-4, atol=1e-5)


def test_build_continues_from_jax_slot_state():
    """The JAX package's slot state carried across (``interop.svi_state``)
    continues to the same coreset as the JAX build itself."""
    x = _data(1)
    jfam, tfam = _exact_families()
    w0, i0 = jnp.zeros(CAP), jnp.full(CAP, -1, jnp.int32)
    jw, ji, js, _ = jsv.svi_build(jnp.asarray(x), w0, i0, jnp.int32(0), jax.random.key(0),
                                  jnp.int32(10), family=jfam, n_sub_sel=None, n_sub_opt=None,
                                  opt_itrs=OPT, step_sched=SCHED)
    tw, ti, ts = interop.svi_state(np.asarray(jw), np.asarray(ji), np.asarray(js))
    assert ti.dtype == torch.int64 and isinstance(ts, int) and ts > 0
    jw2, ji2, js2, _ = jsv.svi_build(jnp.asarray(x), jw, ji, js, jax.random.key(1),
                                     jnp.int32(12), family=jfam, n_sub_sel=None,
                                     n_sub_opt=None, opt_itrs=OPT, step_sched=SCHED)
    tw2, ti2, ts2 = tsv.svi_build(torch.as_tensor(x), tw, ti, ts, torch.Generator(), 12,
                                  family=tfam, n_sub_sel=None, n_sub_opt=None,
                                  opt_itrs=OPT, step_sched=SCHED)
    assert ts2 == int(js2)
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(tw2.numpy(), np.asarray(jw2), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ti[:ts].numpy(), np.asarray(ji)[:ts])   # input untouched


def test_error_pair_shares_one_context():
    x, j, t = _exact_pair(2)
    j.build(8)
    t.build(8)
    w_new = t._wts * 1.5
    kw = dict(family=t.family, n_sub=None)
    e_old, e_new = tsv.svi_error_pair(t.data, t._wts, w_new, t._idcs, t._size,
                                      torch.Generator(), **kw)
    je_old, je_new = jsv.svi_error_pair(j.data, j._wts, j._wts * 1.5, j._idcs, j._size,
                                        jax.random.key(0), family=j.family, n_sub=None)
    np.testing.assert_allclose([float(e_old), float(e_new)], [float(je_old), float(je_new)],
                               rtol=1e-4)
    np.testing.assert_allclose(float(e_old), t.error(), rtol=1e-6)
    # black-box: both errors are read in ONE context built from w_old, so
    # the pair of a weight vector with itself is exactly equal, and e_old
    # equals svi_error under a clone of the same generator state
    fam = _bb_family(torch.as_tensor(x)[:, :D]).family
    g = torch.Generator().manual_seed(3)
    g2 = torch.Generator()
    g2.set_state(g.get_state())
    a, b = tsv.svi_error_pair(t.data, t._wts, t._wts, t._idcs, t._size, g, family=fam, n_sub=64)
    assert float(a) == float(b)
    c = tsv.svi_error(t.data, t._wts, t._idcs, t._size, g2, family=fam, n_sub=64)
    assert float(a) == float(c)


def _bb_family(x, S=50, seed=0, grad=False):
    d = x.shape[1]
    basis = tg.posterior_basis(torch.zeros(d), torch.eye(d), torch.eye(d))

    def sampler(g, n, w, p):
        if p.numel() == 0:
            w, p = torch.zeros(1), torch.zeros((1, d))
        return tg.sample_weighted_post_basis(g, basis, p, w, n)

    eye = torch.eye(d)
    gll = (lambda p, th: tg.grad_x_log_likelihood(p, th, eye)) if grad else None
    return tbc.BlackBoxProjector(sampler, S, lambda p, th: tg.log_likelihood(p, th, eye, 0.0),
                                 gll, generator=torch.Generator().manual_seed(seed))


def _jax_bb_family(d, S=50, grad=False):
    basis = jg.posterior_basis(jnp.zeros(d), jnp.eye(d), jnp.eye(d))

    def sampler(k, n, w, p):
        if p.size == 0:
            w, p = jnp.zeros(1), jnp.zeros((1, d))
        return jg.sample_weighted_post_basis(k, basis, p, w, n)

    eye = jnp.eye(d)
    gll = (lambda p, th: jg.grad_x_log_likelihood(p, th, eye)) if grad else None
    return jbc.BlackBoxProjector(sampler, S, lambda p, th: jg.log_likelihood(p, th, eye, 0.0),
                                 gll)


def _rkl(x, w, p):
    """rKL of the coreset posterior against the full-data posterior, f64."""
    d = x.shape[1]
    mu0, eye = np.zeros(d, np.float32), np.eye(d, dtype=np.float32)
    full = jg.weighted_post(jnp.asarray(mu0), jnp.asarray(eye), jnp.asarray(eye),
                            jnp.asarray(x), jnp.ones(x.shape[0]))
    q = jg.weighted_post(jnp.asarray(mu0), jnp.asarray(eye), jnp.asarray(eye),
                         jnp.asarray(np.atleast_2d(np.asarray(p, np.float32))),
                         jnp.asarray(np.asarray(w, np.float32)))
    return jg.kl_divergence_np(q.mu, q.USig @ q.USig.T, full.mu, full.LSigInv @ full.LSigInv.T)


SEEDS = range(9)
BB = dict(n=300, d=5, M=10, opt=30)


def test_blackbox_rkl_matches_jax_in_distribution():
    x = _data(0, BB["n"], BB["d"])
    jprj, tprj = _jax_bb_family(BB["d"]), _bb_family(torch.as_tensor(x))
    jk, tk = [], []
    for seed in SEEDS:
        j = jbc.SparseVICoreset(jnp.asarray(x), jprj, opt_itrs=BB["opt"], seed=seed, capacity=16)
        t = tbc.SparseVICoreset(torch.as_tensor(x), tprj, opt_itrs=BB["opt"], seed=seed,
                                capacity=16)
        j.build(BB["M"])
        t.build(BB["M"])
        w, p, i = t.get()
        assert np.isfinite(w).all() and (w > 0).all() and len(set(i.tolist())) == i.size
        jk.append(_rkl(x, *j.get()[:2]))
        tk.append(_rkl(x, w, p))
    assert min(jk) <= np.median(tk) <= max(jk), (tk, jk)


@pytest.mark.parametrize("n_sub", [(64, None), (None, 64), (48, 80)])
def test_subsampled_builds(n_sub):
    x = _data(3, 400, 5)
    t = tbc.SparseVICoreset(torch.as_tensor(x), _bb_family(torch.as_tensor(x)),
                            n_subsample_select=n_sub[0], n_subsample_opt=n_sub[1],
                            opt_itrs=10, seed=1)
    t.build(12)
    w, p, i = t.get()
    assert 0 < i.size <= 12 and len(set(i.tolist())) == i.size
    assert np.isfinite(w).all() and (w >= 0).all() and (i < 400).all()
    np.testing.assert_array_equal(p, x[i])
    assert np.isfinite(t.error())
    e = _rkl(x, w, p)
    u = tbc.UniformSamplingCoreset(x, seed=1)
    u.build(12)
    assert e < _rkl(x, *u.get()[:2])


def test_reset_reproduces_and_capacity():
    x = _data(4, 200, 5)
    prj = _bb_family(torch.as_tensor(x))
    a = tbc.SparseVICoreset(torch.as_tensor(x), prj, opt_itrs=10, seed=3, capacity=16)
    assert a._cap == 16
    a.build(5)
    a.build(5)
    assert a.size() <= 10
    first = a.get()
    # the default growth path (8 slots, doubled on demand) gives the same coreset
    b = tbc.SparseVICoreset(torch.as_tensor(x), prj, opt_itrs=10, seed=3)
    b.build(5)
    assert b._cap == 8
    b.build(5)
    assert b._cap == 16
    np.testing.assert_array_equal(b.idcs, first[2])
    np.testing.assert_allclose(b.wts, first[0], rtol=1e-6)
    a.reset()
    assert a._cap == 16 and a.size() == 0 and a._size == 0
    a.build(5)
    a.build(5)
    np.testing.assert_array_equal(a.get()[2], first[2])
    np.testing.assert_array_equal(a.get()[0], first[0])


def test_optimize_crn_rollback():
    """A healthy re-optimization never latches; one that genuinely worsens
    the objective is rolled back and latches the numeric limit."""
    x = _data(5, 300, 5)
    prj = _bb_family(torch.as_tensor(x))
    a = tbc.SparseVICoreset(torch.as_tensor(x), prj, opt_itrs=20, seed=1, capacity=16)
    a.build(8)
    a.optimize()
    assert not a.reached_numeric_limit and a.size() > 0

    b = tbc.SparseVICoreset(torch.as_tensor(x), prj, opt_itrs=20, seed=1, capacity=16)
    b.build(8)
    good = b.wts.copy()

    def corrupt():
        b._wts = b._wts * 50.0
        b._sync()

    b._optimize = corrupt
    b.optimize()
    assert b.reached_numeric_limit
    np.testing.assert_allclose(b.wts, good, rtol=1e-6)
    b.build(3)                                        # latched: a no-op
    np.testing.assert_allclose(b.wts, good, rtol=1e-6)
    # an empty coreset optimizes without a rollback check
    c = tbc.SparseVICoreset(torch.as_tensor(x), prj, opt_itrs=5)
    c.optimize()
    assert c.error() == 0.0 and c.size() == 0


def test_rollback_check_draws_from_its_own_stream():
    """The rollback check's context uses samples that the optimize never
    saw: not those of its first step (which starts at the same weights),
    nor of any later one; and they are reproducible from the seed."""
    x = torch.as_tensor(_data(6, 200, 5))
    d = x.shape[1]
    basis = tg.posterior_basis(torch.zeros(d), torch.eye(d), torch.eye(d))
    drawn = []

    def sampler(g, n, w, p):
        if p.numel() == 0:
            w, p = torch.zeros(1), torch.zeros((1, d))
        out = tg.sample_weighted_post_basis(g, basis, p, w, n)
        drawn.append(out.clone())
        return out

    eye = torch.eye(d)
    prj = tbc.BlackBoxProjector(sampler, 30, lambda p, th: tg.log_likelihood(p, th, eye, 0.0),
                                generator=torch.Generator().manual_seed(0))
    checks = []
    for _ in range(2):
        a = tbc.SparseVICoreset(x, prj, opt_itrs=4, seed=2, capacity=8)
        a.build(5)
        del drawn[:]
        a.optimize()
        assert len(drawn) == 4 + 1 and not a.reached_numeric_limit
        steps, check = drawn[:-1], drawn[-1]
        # the first step and the check share the weights, so equal draws
        # would give equal samples
        assert all(not torch.equal(check, s) for s in steps)
        checks.append(check)
    assert torch.equal(checks[0], checks[1])


def test_save_restore_resumes(tmp_path):
    x = _data(6, 100, 5)
    prj = _bb_family(torch.as_tensor(x))
    svi = tbc.SparseVICoreset(torch.as_tensor(x), prj, opt_itrs=5)
    svi.build(4)
    p = str(tmp_path / "svi.npz")
    svi.save(p)
    svi2 = tbc.SparseVICoreset(torch.as_tensor(x), prj, opt_itrs=5, seed=9)
    svi2.restore(p)
    assert svi2.size() == svi.size()
    np.testing.assert_array_equal(svi2.idcs, svi.idcs)
    # the generator came back too: both continue identically
    svi.build(4)
    svi2.build(4)
    np.testing.assert_array_equal(svi2.idcs, svi.idcs)
    np.testing.assert_array_equal(svi2.wts, svi.wts)
    assert svi2.size() >= 4


def test_rejects_non_family_projector():
    with pytest.raises(TypeError):
        tbc.SparseVICoreset(torch.zeros((5, 2)), object())
    x = torch.as_tensor(_data(7, 50, 3))
    svi = tbc.SparseVICoreset(x, _bb_family(x), opt_itrs=3)
    svi.build(0)
    svi.build(-2)
    assert svi.size() == 0 and svi.error() == 0.0
