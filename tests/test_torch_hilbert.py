"""The port's slice as a whole against the JAX package: a Hilbert coreset
on logistic data with the int8 select and max_active=1024.

Both sides project the same data against the same numpy-made θ samples
(the samplers return them whatever generator or key they are given).  The
coreset indices must be identical; weights and error() agree within rtol
1e-4 (f32 projections and O(S) dots summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_coresets_tpu as jbc
import bayesian_coresets_tpu_torch as tbc
from bayesian_coresets_tpu.models import logistic as jlr
from bayesian_coresets_tpu_torch.models import logistic as tlr
from bayesian_coresets_tpu_torch.utils import config

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


N, D, S, M = 2000, 5, 64, 100


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = np.where(rng.uniform(size=N) < 1 / (1 + np.exp(-x @ np.full(D, 2.0))), 1.0, -1.0)
    z = (y[:, None] * x).astype(np.float32)
    th = (np.full(D, 1.0) + 0.3 * rng.normal(size=(S, D))).astype(np.float32)
    return z, th


def _coresets(n_subsample=None, seed=0):
    z, th = _data(seed)
    jproj = jbc.BlackBoxProjector(lambda k, n, w, p: jnp.asarray(th), S,
                                  jlr.log_likelihood)
    tproj = tbc.BlackBoxProjector(lambda g, n, w, p: torch.as_tensor(th), S,
                                  tlr.log_likelihood)
    j = jbc.HilbertCoreset(z, jproj, n_subsample=n_subsample, select_dtype=jnp.int8,
                           max_active=1024, seed=seed)
    t = tbc.HilbertCoreset(torch.as_tensor(z), tproj, n_subsample=n_subsample,
                           select_dtype=torch.int8, max_active=1024, seed=seed)
    # select on the same bytes (the int8 copies may differ by ±1 where the
    # f32 projections round differently at a boundary)
    q = t.snnls.consts.Vsel.numpy()
    jv = np.zeros(j.snnls.consts.Vsel.shape, np.int8)
    jv[:q.shape[0], :q.shape[1]] = q
    j.snnls.consts = j.snnls.consts._replace(Vsel=jnp.asarray(jv))
    return j, t


@pytest.mark.parametrize("n_subsample", [None, 1200])
def test_hilbert_coreset_matches_jax(n_subsample):
    j, t = _coresets(n_subsample)
    j.build(M)
    t.build(M)
    jw, jp, ji = j.get()
    tw, tp, ti = t.get()
    assert ti.size > 0
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=1e-4)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)
    assert t.reached_numeric_limit == j.reached_numeric_limit
    if n_subsample is not None:
        np.testing.assert_array_equal(t.sub_idcs, j.sub_idcs)
        assert set(ti) <= set(t.sub_idcs)


def test_hilbert_error_falls_and_reset_rebuilds():
    _, t = _coresets(seed=1)
    t.build(20)
    e20, i20 = t.error(), t.get()[2]
    t.build(60)
    assert t.error() < e20
    t.reset()
    assert t.get()[0].size == 0
    t.build(20)
    np.testing.assert_array_equal(t.get()[2], i20)
    np.testing.assert_allclose(t.error(), e20, rtol=1e-6)


def test_projector_centers_over_samples():
    z, th = _data()
    proj = tbc.BlackBoxProjector(lambda g, n, w, p: torch.as_tensor(th), S,
                                 tlr.log_likelihood)
    v = proj.project(torch.as_tensor(z[:10]))
    assert v.shape == (10, S)
    np.testing.assert_allclose(v.mean(dim=1).numpy(), 0.0, atol=1e-5)
    assert torch.equal(proj.samples, torch.as_tensor(th))
