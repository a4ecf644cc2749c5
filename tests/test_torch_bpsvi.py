"""BatchPSVI and the uniform-sampling baseline of the port against the JAX
package, and the slice as a whole.

- With the exact Gaussian tangent family, no subsampling and the same
  ``init_idcs``, nothing is drawn at random: the joint (w, pts) after the
  Adam steps agree within rtol 1e-4, atol 1e-5 (the JAX basis carried
  across, as in ``test_torch_svi.py``).
- Black-box builds are held in distribution: the port's median rKL over 9
  seeds lies within the spread of the JAX package's.
- The slice as a whole: the gaussian experiment's algorithms (SVI, BPSVI,
  US) through the port's public API order by rKL as the JAX package's do on
  the same data and seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_coresets_tpu as jbc
import bayesian_coresets_tpu_torch as tbc
from bayesian_coresets_tpu.coresets import bpsvi as jbp
from bayesian_coresets_tpu_torch.coresets import bpsvi as tbp
from bayesian_coresets_tpu_torch.utils import config
from test_torch_svi import _bb_family, _data, _exact_families, _jax_bb_family, _rkl

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


SCHED = lambda i: 1.0 / (1.0 + i)   # noqa: E731


@pytest.mark.parametrize("n_steps", [1, 40])
def test_exact_family_build_matches_jax(n_steps):
    x = _data(0, 200, 6)
    jfam, tfam = _exact_families(6)
    init = np.random.default_rng(1).choice(200, size=12, replace=False)
    jw, jp = jbp.bpsvi_build(jnp.asarray(x), jnp.asarray(init, jnp.int32), jax.random.key(0),
                             family=jfam, n_sub_opt=None, opt_itrs=n_steps, step_sched=SCHED)
    tw, tp = tbp.bpsvi_build(torch.as_tensor(x), torch.as_tensor(init), torch.Generator(),
                             family=tfam, n_sub_opt=None, opt_itrs=n_steps, step_sched=SCHED)
    assert tw.shape == (12,) and tp.shape == (12, 6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-5)
    assert not np.allclose(tp.numpy(), x[init])          # the points moved
    e = [float(tbp.bpsvi_error(torch.as_tensor(x), w, p, torch.Generator(), family=tfam,
                               n_sub=None))
         for w, p in [(torch.full((12,), 200 / 12), torch.as_tensor(x[init])), (tw, tp)]]
    je = float(jbp.bpsvi_error(jnp.asarray(x), jw, jp, jax.random.key(0), family=jfam,
                               n_sub=None))
    np.testing.assert_allclose(e[1], je, rtol=1e-4)
    if n_steps > 1:          # (Adam's first step, of size 1 per coordinate, overshoots)
        assert e[1] < e[0]


def test_blackbox_rkl_matches_jax_in_distribution():
    x = _data(2, 300, 5)
    jprj = _jax_bb_family(5, grad=True)
    tprj = _bb_family(torch.as_tensor(x), grad=True)
    jk, tk, tk0 = [], [], []
    for seed in range(9):
        j = jbc.BatchPSVICoreset(jnp.asarray(x), jprj, opt_itrs=60, seed=seed)
        t = tbc.BatchPSVICoreset(torch.as_tensor(x), tprj, opt_itrs=60, seed=seed)
        j.build(8)
        t.build(8)
        w, p, i = t.get()
        assert w.shape == (8,) and p.shape == (8, 5) and (i == -1).all()
        assert np.isfinite(p).all() and (w >= 0).all()
        jk.append(_rkl(x, *j.get()[:2]))
        tk.append(_rkl(x, w, p))
        t0 = tbc.BatchPSVICoreset(torch.as_tensor(x), tprj, opt_itrs=0, seed=seed)
        t0.build(8)
        tk0.append(_rkl(x, *t0.get()[:2]))
    assert min(jk) <= np.median(tk) <= max(jk), (tk, jk)
    assert np.median(tk) < 0.1 * np.median(tk0)


def test_subsampled_build_error_and_reset():
    x = _data(3, 400, 5)
    prj = _bb_family(torch.as_tensor(x), grad=True)
    t = tbc.BatchPSVICoreset(torch.as_tensor(x), prj, opt_itrs=40, n_subsample_opt=64, seed=2)
    assert t.error() == 0.0
    t.build(6)
    w, p, _ = t.get()
    e = t.error()
    assert np.isfinite(e) and np.isfinite(p).all()
    t0 = tbc.BatchPSVICoreset(torch.as_tensor(x), prj, opt_itrs=0, n_subsample_opt=64, seed=2)
    t0.build(6)
    assert e < t0.error()
    t.reset()
    t.build(6)
    np.testing.assert_array_equal(t.get()[1], p)
    np.testing.assert_array_equal(t.get()[0], w)


def test_requires_project_grad_and_uniform_init():
    x = torch.as_tensor(_data(4, 50, 3))
    with pytest.raises(ValueError):
        tbc.BatchPSVICoreset(x, _bb_family(x), opt_itrs=5)
    _, tfam = _exact_families(3)
    tbc.BatchPSVICoreset(x, tfam, opt_itrs=5)          # exact families have it
    a = tbp.uniform_init_idcs(50, 20, torch.Generator().manual_seed(0))
    b = tbp.uniform_init_idcs(50, 20, torch.Generator().manual_seed(0))
    assert len(set(a.tolist())) == 20 and int(a.min()) >= 0 and int(a.max()) < 50
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_uniform_sampling_weights_and_reset():
    x = _data(5, 40, 3)
    u = tbc.UniformSamplingCoreset(torch.as_tensor(x), seed=4)
    j = jbc.UniformSamplingCoreset(x, seed=4)
    u.build(25)
    j.build(25)
    w, p, i = u.get()
    draws = np.random.default_rng(4).integers(0, 40, size=25)
    cts = np.bincount(draws, minlength=40)
    np.testing.assert_allclose(w, 40 * cts[i] / 25)
    assert abs(w.sum() - 40) < 1e-9
    np.testing.assert_array_equal(p, x[i])
    for a, b in zip(u.get(), j.get()):
        np.testing.assert_array_equal(a, b)
    u.build(5)
    assert u.get()[0].sum() == pytest.approx(40)
    u.reset()
    u.build(25)
    np.testing.assert_array_equal(u.get()[2], i)
    assert u.error() == 0.0


def test_gaussian_experiment_slice_orders_like_jax():
    """SVI (black-box and exact), BPSVI and US on the gaussian experiment's
    model at small N and d: median rKL over three seeds, ordered alike."""
    n, d, S, M = 300, 5, 50, 10
    x = _data(6, n, d)
    jfam, tfam = _exact_families(d)
    jprj, tprj = _jax_bb_family(d, S, grad=True), _bb_family(torch.as_tensor(x), S, grad=True)
    xt = torch.as_tensor(x)
    algs = {
        "SVI": (lambda s: jbc.SparseVICoreset(jnp.asarray(x), jprj, opt_itrs=30, seed=s,
                                              capacity=16),
                lambda s: tbc.SparseVICoreset(xt, tprj, opt_itrs=30, seed=s, capacity=16)),
        "SVI-EXACT": (lambda s: jbc.SparseVICoreset(jnp.asarray(x), jfam, opt_itrs=30, seed=s,
                                                    capacity=16),
                      lambda s: tbc.SparseVICoreset(xt, tfam, opt_itrs=30, seed=s, capacity=16)),
        "BPSVI": (lambda s: jbc.BatchPSVICoreset(jnp.asarray(x), jprj, opt_itrs=100, seed=s),
                  lambda s: tbc.BatchPSVICoreset(xt, tprj, opt_itrs=100, seed=s)),
        "US": (lambda s: jbc.UniformSamplingCoreset(x, seed=s),
               lambda s: tbc.UniformSamplingCoreset(xt, seed=s)),
    }
    med = {}
    for name, (jmake, tmake) in algs.items():
        for side, make in (("jax", jmake), ("torch", tmake)):
            ks = []
            for seed in range(3):
                c = make(seed)
                c.build(M)
                ks.append(_rkl(x, *c.get()[:2]))
            med[name, side] = np.median(ks)
    order = {side: sorted(algs, key=lambda a: med[a, side]) for side in ("jax", "torch")}
    assert order["torch"] == order["jax"], med
