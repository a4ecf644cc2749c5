"""The port's active-set re-solve (``optimize()``) and checkpoints against
the JAX package.

- FISTA (``ops/nnls.py``, ``snnls.optimize_active``) on the same numpy
  problem: weights within rtol 1e-4 (atol 1e-6), errors within rtol 1e-5;
  the port takes its (K, K) Gram products and O(S) reductions in other
  orders than XLA.
- The exact solver: both packages run the same ``nnls.cpp`` in f64, on
  active rows that agree to f32 rounding: weights within rtol 1e-5.
- ``HilbertCoreset.optimize()`` through the public API, as
  ``tests/test_snnls.py`` does it for the JAX package.
- The rollback latch, and checkpointed builds that resume
  (``tests/test_utils.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_coresets_tpu as jbc
import bayesian_coresets_tpu_torch as tbc
from bayesian_coresets_tpu import native as jnative
from bayesian_coresets_tpu.ops import nnls as jnn
from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu_torch import native as tnative
from bayesian_coresets_tpu_torch.ops import nnls as tnn
from bayesian_coresets_tpu_torch.ops import snnls as tsn
from bayesian_coresets_tpu_torch.utils import checkpoint
from bayesian_coresets_tpu_torch.utils import config

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


def _problem(seed=0, S=60, n=150):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    return A, A.sum(axis=1)


def _built(A, b, itrs=40):
    j, t = jsn.GIGA(A, b), tsn.GIGA(torch.as_tensor(A), torch.as_tensor(b))
    j.build(itrs)
    t.build(itrs)
    np.testing.assert_array_equal(np.flatnonzero(t.weights() > 0),
                                  np.flatnonzero(np.asarray(j.weights()) > 0))
    return j, t


def test_nnls_gram_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(12, 40)).astype(np.float32)
    G, c = X @ X.T, X @ rng.normal(size=40).astype(np.float32)
    j = np.asarray(jnn.nnls_gram(jnp.asarray(G), jnp.asarray(c)))
    t = tnn.nnls_gram(torch.as_tensor(G), torch.as_tensor(c)).numpy()
    assert (t >= 0).all() and (t == 0).any()          # the constraint binds
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tnn._power_iteration_sym(torch.as_tensor(G))),
                               float(jnn._power_iteration_sym(jnp.asarray(G))), rtol=1e-5)


@pytest.mark.parametrize("size", [5, 8])
def test_nnls_active_set_matches_jax(size):
    A, b = _problem(2)
    V = np.ascontiguousarray(A.T)
    idcs = np.array([3, 17, 40, 41, 99, 120, 7, 0], np.int32)
    j = np.asarray(jnn.nnls_active_set(jnp.asarray(V), jnp.asarray(b), jnp.asarray(idcs), size))
    t = tnn.nnls_active_set(torch.as_tensor(V), torch.as_tensor(b),
                            torch.as_tensor(idcs).long(), size).numpy()
    assert (t[size:] == 0).all()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("num_iters", [512, 1])
def test_optimize_active_matches_jax(num_iters):
    """512 FISTA steps lower the cost; one step from zero raises it, so the
    re-solve is refused, the weights stay and ``done`` latches."""
    A, b = _problem(3)
    j, t = _built(A, b)
    act = np.flatnonzero(t.weights() > 0)
    idcs = np.zeros(64, np.int32)
    idcs[:act.size] = act
    js, jok = jsn.optimize_active(j.consts, j.state, jnp.asarray(idcs), jnp.int32(act.size),
                                  1e-6, num_iters=num_iters)
    ts, tok = tsn.optimize_active(t.consts, t.state, torch.as_tensor(idcs), act.size, 1e-6,
                                  num_iters=num_iters)
    assert bool(tok) == bool(jok) == (num_iters > 1)
    assert bool(ts.done) == (not bool(tok))
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.xw.numpy(), np.asarray(js.xw), rtol=1e-4, atol=1e-4)
    if not bool(tok):
        np.testing.assert_array_equal(ts.w.numpy(), t.state.w.numpy())


def test_facade_optimize_matches_jax_fista():
    A, b = _problem(4)
    j, t = _built(A, b)
    e0 = t.error()
    j.optimize()
    t.optimize()
    assert not t.reached_numeric_limit
    assert t.error() <= e0
    np.testing.assert_allclose(t.weights(), np.asarray(j.weights()), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-5)


def test_optimize_exact_matches_native_jax():
    if not jnative.available():
        pytest.skip("no C++ toolchain for the JAX package's native solver")
    A, b = _problem(5)
    j, t = _built(A, b)
    e0 = t.error()
    j.optimize(solver="exact")
    t.optimize(solver="exact")
    assert t.error() <= e0 * (1 + 1e-4)
    np.testing.assert_allclose(t.weights(), np.asarray(j.weights()), rtol=1e-5, atol=1e-7)
    # the exact solve matches or beats FISTA on the same active set
    _, f = _built(A, b)
    f.optimize()
    assert t.error() <= f.error() * (1 + 1e-3)
    # the cached image follows the new weights, so a build can continue
    np.testing.assert_allclose(t.state.xw.numpy(), (A @ t.weights()), rtol=1e-4, atol=1e-4)
    t.build(10)
    assert np.isfinite(t.error())


def test_native_matches_scipy_and_raises_without_compiler(monkeypatch):
    from scipy.optimize import nnls as scipy_nnls
    rng = np.random.default_rng(6)
    A, b = rng.normal(size=(20, 8)), rng.normal(size=20)
    x, r = tnative.nnls(A, b)
    xs, rs = scipy_nnls(A, b)
    np.testing.assert_allclose(x, xs, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r, rs, rtol=1e-9)
    assert tnative.library_path().parent.name == "native"
    # no silent fallback: without g++ the exact solver raises
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    _, t = _built(*_problem(7))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        t.optimize(solver="exact")
    with pytest.raises(ValueError):
        t.optimize(solver="lbfgs")


N, S, M = 300, 60, 40


def _hilbert_pair(seed=0):
    """Hilbert coresets over raw feature vectors (the identity family): an
    active set of M atoms in S=60 dimensions keeps the (K, K) Gram well
    conditioned, so FISTA's 512 steps settle and both packages agree.  (On
    a rank-deficient Gram, e.g. 33 atoms in 30 dimensions, the minimizer is
    not unique and FISTA's iterates part at the first rounding.)"""
    rng = np.random.default_rng(seed)
    x = (1.0 + rng.normal(size=(N, S))).astype(np.float32)
    j = jbc.HilbertCoreset(x, jbc.coresets.FamilyProjector(jbc.coresets.identity_tangent_family()))
    t = tbc.HilbertCoreset(torch.as_tensor(x), tbc.FamilyProjector(tbc.identity_tangent_family()))
    return j, t


def test_hilbert_coreset_optimize_matches_jax():
    j, t = _hilbert_pair()
    j.build(M)
    t.build(M)
    np.testing.assert_array_equal(t.get()[2], j.get()[2])
    e0 = t.error()
    j.optimize()
    t.optimize()
    assert not t.reached_numeric_limit
    assert t.error() <= e0
    jw, jp, ji = j.get()
    tw, tp, ti = t.get()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-5)


def test_hilbert_optimize_refused_latches(monkeypatch):
    """A re-solve that raises the cost (one FISTA step from zero) is refused
    inside the solver: the coreset keeps its weights and latches."""
    _, t = _hilbert_pair(1)
    t.build(M)
    before = t.get()
    monkeypatch.setattr(tsn, "optimize_active",
                        functools.partial(tsn.optimize_active, num_iters=1))
    t.optimize()
    assert t.reached_numeric_limit
    np.testing.assert_array_equal(t.get()[0], before[0])
    t.build(5)                                   # latched: a no-op
    np.testing.assert_array_equal(t.get()[2], before[2])


def test_solver_save_restore_resumes(tmp_path):
    A, b = _problem(8, S=30, n=120)
    ref = tsn.GIGA(torch.as_tensor(A), torch.as_tensor(b))
    ref.build(40)
    a = tsn.GIGA(torch.as_tensor(A), torch.as_tensor(b))
    a.build(15)
    p = str(tmp_path / "solver.npz")
    a.save(p)
    fresh = tsn.GIGA(torch.as_tensor(A), torch.as_tensor(b))
    fresh.restore(p)
    assert fresh.state.idcs.dtype == torch.int32 and fresh.state.done.dtype == torch.bool
    fresh.build(25)
    np.testing.assert_allclose(fresh.weights(), ref.weights(), rtol=1e-5, atol=1e-6)


def test_checkpointed_build_resumes(tmp_path):
    A, b = _problem(9, S=30, n=120)
    ck = str(tmp_path / "auto.npz")
    ref = tsn.GIGA(torch.as_tensor(A), torch.as_tensor(b))
    ref.build(40)
    a = tsn.GIGA(torch.as_tensor(A), torch.as_tensor(b))
    a.build(40, checkpoint_path=ck, checkpoint_every=10)
    np.testing.assert_allclose(a.weights(), ref.weights(), rtol=1e-5, atol=1e-6)
    # a fresh instance asked for the same build restores instead of redoing it
    fresh = tsn.GIGA(torch.as_tensor(A), torch.as_tensor(b))
    fresh.build(40, checkpoint_path=ck, checkpoint_every=10)
    np.testing.assert_allclose(fresh.weights(), ref.weights(), rtol=1e-5, atol=1e-6)
    assert int(fresh.state.itr) == 40


def test_checkpoint_tuple_and_generator_roundtrip(tmp_path):
    p = str(tmp_path / "ck.npz")
    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    tree = (torch.arange(4, dtype=torch.float32), torch.tensor([1, -1]), 7)
    checkpoint.save(p, tree, meta={"k": 1}, generator=gen)
    expect = torch.rand(5, generator=gen)
    g2 = torch.Generator().manual_seed(0)
    leaves, meta = checkpoint.load(p, generator=g2)
    assert meta == {"k": 1} and len(leaves) == 3 and int(leaves[2]) == 7
    np.testing.assert_array_equal(leaves[1].numpy(), [1, -1])
    np.testing.assert_array_equal(torch.rand(5, generator=g2).numpy(), expect.numpy())
    with pytest.raises(ValueError):
        checkpoint.load(p, like=(torch.zeros(1),))
    checkpoint.save(p, tree)
    with pytest.raises(ValueError):
        checkpoint.load(p, generator=g2)
