"""Frank-Wolfe, OMP and the sampling solvers of the PyTorch port against the
JAX package's ``snnls.build(method=...)``.

Both run on the same numpy A, b (S=256, n=512 as the GIGA parity tests).
Frank-Wolfe and OMP must select the same atoms in the same order
(``state.idcs[:size]``), with ``itr``, ``fail`` and ``done`` equal; weights
agree within rtol 1e-5, atol 1e-6 (Frank-Wolfe: the port accumulates its
O(S) dots in f64) or rtol 1e-4 (OMP: 256 FISTA steps per iteration, each a
(K, K) product summed in another order).  The sampling solvers draw from
another generator than ``jax.random``, so the indices that the JAX package
drew are replayed into the port (counts, weights and cached image then agree
within rtol 1e-5), and the port's own draws are held to ``ps`` in
distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_coresets_tpu as jbc
import bayesian_coresets_tpu_torch as tbc
from bayesian_coresets_tpu.models import logistic as jlr
from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu_torch.models import logistic as tlr
from bayesian_coresets_tpu_torch.ops import snnls as tsn
from bayesian_coresets_tpu_torch.utils import config, interop
from bayesian_coresets_tpu_torch.utils.errors import NumericalPrecisionError

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


SD = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16),
      "int8": (jnp.int8, torch.int8)}
S_DIM, N = 256, 512
TOL = {"frankwolfe": dict(rtol=1e-5, atol=1e-6), "orthopursuit": dict(rtol=1e-4, atol=1e-6)}
FACADES = {"giga": (jsn.GIGA, tsn.GIGA), "frankwolfe": (jsn.FrankWolfe, tsn.FrankWolfe),
           "orthopursuit": (jsn.OrthoPursuit, tsn.OrthoPursuit),
           "importance": (jsn.ImportanceSampling, tsn.ImportanceSampling),
           "uniform": (jsn.UniformSampling, tsn.UniformSampling)}


def _problem(seed=0, S=S_DIM, n=N):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    return A, A.sum(axis=1)


def _np(tree):
    """A JAX NamedTuple with every field as numpy (PRNG keys as key data)."""
    def conv(x):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        return np.asarray(x)
    return type(tree)(*map(conv, tree))


def _consts(sd, A, b, sampling=None, valid=None):
    jsd, tsd = SD[sd]
    jc = jsn.make_consts(A, b, valid=valid, sampling=sampling, select_dtype=jsd)
    tc = tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b), sampling=sampling,
                         valid=None if valid is None else torch.as_tensor(valid),
                         select_dtype=tsd)
    if sd == "int8":
        # both must select on the same bytes: the copies may differ by ±1
        # where the row norms (summed in another order) put an entry on a
        # rounding boundary
        q = tc.Vsel.numpy()
        out = np.zeros(jc.Vsel.shape, np.int8)
        out[:q.shape[0], :q.shape[1]] = q
        jc = jc._replace(Vsel=jnp.asarray(out))
    return jc, tc


def _compare(js, ts, rtol, atol):
    k = int(js.size)
    assert (int(ts.size), int(ts.itr), int(ts.fail), bool(ts.done)) == \
        (k, int(js.itr), int(js.fail), bool(js.done))
    np.testing.assert_array_equal(ts.idcs[:k].numpy(), np.asarray(js.idcs)[:k])
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ts.xw.numpy(), np.asarray(js.xw), rtol=max(rtol, 1e-4), atol=1e-4)


# ---------------------------------------------------------------------------
# Frank-Wolfe and OMP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sd", list(SD))
def test_frankwolfe_build_matches_jax(sd):
    """140 iterations: the wscale fold of the first (alpha == 0) and two
    refreshes lie inside."""
    A, b = _problem()
    jc, tc = _consts(sd, A, b)
    js = jsn.build(jc, jsn.init_state(jc, max_active=256), 140, 1e-6, method="frankwolfe")
    ts = tsn.build(tc, tsn.init_state(tc, 256), 140, 1e-6, method="frankwolfe")
    assert int(js.itr) == 140 and not bool(js.done) and int(js.size) > 20
    _compare(js, ts, **TOL["frankwolfe"])
    np.testing.assert_allclose(float(tsn.error(tc, ts.w)), float(jsn.error(jc, js.w)), rtol=1e-4)


@pytest.mark.parametrize("sd", list(SD))
def test_omp_build_matches_jax(sd):
    A, b = _problem(1, S=64, n=200)
    jc, tc = _consts(sd, A, b)
    js = jsn.build(jc, jsn.init_state(jc, max_active=32), 20, 1e-6, method="orthopursuit")
    ts = tsn.build(tc, tsn.init_state(tc, 32), 20, 1e-6, method="orthopursuit")
    assert int(js.itr) == 20 and not bool(js.done) and int(js.size) == 20
    _compare(js, ts, **TOL["orthopursuit"])


@pytest.mark.parametrize("method", ["frankwolfe", "orthopursuit"])
def test_build_without_support_slots_matches_jax(method):
    """max_active=0: dense refreshes and the any(w > 0) gates.  OMP then has
    no slots to solve on, and its weights stay 0 in both packages."""
    A, b = _problem(2, S=64, n=200)
    jc, tc = _consts("float32", A, b)
    js = jsn.build(jc, jsn.init_state(jc), 70, 1e-6, method=method)
    ts = tsn.build(tc, tsn.init_state(tc), 70, 1e-6, method=method)
    _compare(js, ts, **TOL[method])
    assert bool((ts.w > 0).any()) == (method == "frankwolfe")


@pytest.mark.parametrize("method,itrs", [("frankwolfe", 50), ("orthopursuit", 8)])
def test_resume_from_jax_state(method, itrs):
    """Half the iterations in JAX, carried across, the rest in the port,
    against all of them in JAX."""
    A, b = _problem(3, S=64, n=200)
    jc, tc = _consts("int8", A, b)
    half = jsn.build(jc, jsn.init_state(jc, max_active=64), itrs, 1e-6, method=method)
    half_np = _np(half)
    full = jsn.build(jc, jsn.init_state(jc, max_active=64), 2 * itrs, 1e-6, method=method)
    tc2 = interop.snnls_consts(_np(jc))
    assert torch.equal(tc2.Vsel, tc.Vsel) and tc2.ps.shape == (0,)
    ts = tsn.build(tc2, interop.snnls_state(half_np), itrs, 1e-6, method=method)
    _compare(full, ts, **TOL[method])


def test_frankwolfe_fold_step_matches_jax():
    """One step entered with a carried scale below the fold floor: the fold
    writes TRUE weights and resets the scale, as in the JAX package."""
    A, b = _problem(S=16, n=48)
    jc, tc = _consts("float32", A, b)
    js = jsn.build(jc, jsn.init_state(jc, max_active=16), 3, 1e-6, method="frankwolfe")
    ws = jsn._WSCALE_FLOOR / 4.0
    xw = (A.astype(np.float64) @ np.asarray(js.w)).astype(np.float32)
    raw_j = js._replace(w=js.w / ws, xw=jnp.asarray(xw))
    out = jsn._fw_step(jc, raw_j, jsn._aux_from_xw(jc, raw_j.xw, wscale=ws), 1e-6)

    raw_t = interop.snnls_state(_np(raw_j))
    nsum = torch.sum(torch.where(tc.valid, tc.norms, 0.0))
    st = tsn._fw_step(tc, raw_t, tsn._aux_from_xw(tc, raw_t.xw, wscale=ws), 1e-6, nsum)
    fold_commit = bool(st.fold & st.commit)
    assert fold_commit and bool(out[6])
    w2, xw2, _, _, aux2 = tsn._carried_commit(raw_t, st)
    assert float(aux2.wscale) == 1.0 == float(out[8].wscale)
    np.testing.assert_allclose(w2.numpy(), np.asarray(out[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xw2.numpy(), np.asarray(out[1]), rtol=1e-4, atol=1e-5)


def test_omp_takes_the_negative_side():
    """A state whose one active atom is overweighted: the residual points
    against it, the largest negated dot (over the active rows) beats the
    largest dot, and the step re-solves on that atom instead of adding one."""
    A, b = _problem(4, S=64, n=200)
    jc, tc = _consts("float32", A, b)
    j, c = 17, 40.0
    js = jsn.init_state(jc, max_active=16)
    js = js._replace(w=js.w.at[j].set(c), xw=jnp.asarray(c * A[:, j]),
                     idcs=js.idcs.at[0].set(j), size=jnp.int32(1))
    # the premise, from the definition: normalized dots against the residual
    r = b - c * A[:, j]
    dots = (A.T @ (r / np.linalg.norm(r))) / np.linalg.norm(A, axis=0)
    assert -dots[j] > dots.max()
    ts = interop.snnls_state(_np(js))
    j1 = jsn.build(jc, js, 1, 1e-6, method="orthopursuit")
    t1 = tsn.build(tc, ts, 1, 1e-6, method="orthopursuit")
    assert int(t1.size) == 1 and int(t1.idcs[0]) == j and 0 < float(t1.w[j]) < c
    _compare(j1, t1, **TOL["orthopursuit"])
    j5 = jsn.build(jc, j1, 5, 1e-6, method="orthopursuit")
    t5 = tsn.build(tc, t1, 5, 1e-6, method="orthopursuit")
    _compare(j5, t5, **TOL["orthopursuit"])


def test_omp_negative_side_takes_the_lowest_row_among_equal_values():
    """Two active copies of one atom, tracked in the order (high row, low
    row): an argmax over all rows in index order returns the low row."""
    A, b = _problem(5, S=32, n=60)
    A[:, 50] = A[:, 9]
    jc, tc = _consts("float32", A, b)
    c = 30.0
    js = jsn.init_state(jc, max_active=8)
    js = js._replace(w=js.w.at[jnp.array([50, 9])].set(c), xw=jnp.asarray(2 * c * A[:, 9]),
                     idcs=js.idcs.at[:2].set(jnp.array([50, 9])), size=jnp.int32(2))
    ts = interop.snnls_state(_np(js))
    seen = []
    track = tsn._track_support
    try:
        tsn._track_support = lambda state, f: (seen.append(int(f)), track(state, f))[1]
        t1 = tsn.build(tc, ts, 1, 1e-6, method="orthopursuit")
    finally:
        tsn._track_support = track
    assert seen == [9]
    _compare(jsn.build(jc, js, 1, 1e-6, method="orthopursuit"), t1, **TOL["orthopursuit"])


def test_frankwolfe_monotone_latch_matches_jax():
    """One valid atom, overweighted past its vertex's reach: the line search
    fails twice and ``done`` latches with the weights untouched."""
    A = np.zeros((8, 2), np.float32)
    A[:, 0] = np.arange(1, 9)
    A[:, 1] = 1.0
    b = 2.0 * A[:, 0]
    valid = np.array([True, False])
    jc, tc = _consts("float32", A, b, valid=valid)
    js = jsn.init_state(jc, max_active=2)
    js = js._replace(w=js.w.at[0].set(1.5), xw=jnp.asarray(1.5 * A[:, 0]),
                     idcs=js.idcs.at[0].set(0), size=jnp.int32(1))
    ts = interop.snnls_state(_np(js))
    j2 = jsn.build(jc, js, 5, 1e-6, method="frankwolfe")
    t2 = tsn.build(tc, ts, 5, 1e-6, method="frankwolfe")
    assert bool(t2.done) and int(t2.itr) == 2 and int(t2.fail) == 2
    _compare(j2, t2, **TOL["frankwolfe"])
    np.testing.assert_array_equal(t2.w.numpy(), [1.5, 0.0])


@pytest.mark.parametrize("method", ["frankwolfe", "orthopursuit"])
def test_support_overflow_latches_like_jax(method):
    A, b = _problem(6, S=64, n=200)
    jc, tc = _consts("float32", A, b)
    js = jsn.build(jc, jsn.init_state(jc, max_active=8), 50, 1e-6, method=method)
    ts = tsn.build(tc, tsn.init_state(tc, 8), 50, 1e-6, method=method)
    assert bool(js.done) and bool(ts.done)
    _compare(js, ts, **TOL[method])
    assert int((ts.w > 0).sum()) <= 8


# ---------------------------------------------------------------------------
# Importance and uniform sampling
# ---------------------------------------------------------------------------

class Replay:
    """A draw source that hands back given indices, one per draw."""

    def __init__(self, indices):
        self.indices = list(indices)

    def index(self, cdf):
        return torch.tensor([self.indices.pop(0)], dtype=torch.int64)


def _jax_draws(state, consts, T):
    """The indices ``_sampling_step`` draws from ``state.key`` (ops/snnls.py:
    819-833 of the JAX package)."""
    ps = consts.ps
    logp = jnp.where(ps > 0, jnp.log(jnp.where(ps > 0, ps, 1.0)), -jnp.inf)
    key, out = state.key, []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(int(jax.random.categorical(sub, logp)))
    return out


def _sampling_problem(seed=7, S=48, n=120):
    A, b = _problem(seed, S=S, n=n)
    A *= np.random.default_rng(seed).uniform(0.2, 3.0, size=n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[[3, n - 43]] = False
    return A, A[:, valid].sum(axis=1), valid


@pytest.mark.parametrize("sampling", ["importance", "uniform"])
def test_sampling_probabilities_match_jax(sampling):
    A, b, valid = _sampling_problem()
    jc, tc = _consts("float32", A, b, sampling=sampling, valid=valid)
    np.testing.assert_allclose(tc.ps.numpy(), np.asarray(jc.ps), rtol=1e-6)
    assert tc.ps.shape == (A.shape[1],) and not tc.ps[[3, 77]].any()
    np.testing.assert_allclose(float(tc.ps.sum()), 1.0, rtol=1e-5)
    # importance falls back to uniform over the valid rows when the norms sum to 0
    Z = np.zeros_like(A)
    jz, tz = _consts("float32", Z, b, sampling="importance", valid=valid)
    np.testing.assert_array_equal(tz.ps.numpy(), np.asarray(jz.ps))
    # the greedy solvers carry no probabilities and no counts
    _, tg = _consts("float32", A, b)
    assert tg.ps.shape == (0,) and tsn.init_state(tg, 4).cts.shape == (0,)
    assert tsn.init_state(tc, 4).cts.shape == (A.shape[1],)
    assert interop.snnls_consts(_np(jc)).ps.shape == (A.shape[1],)


@pytest.mark.parametrize("sampling", ["importance", "uniform"])
@pytest.mark.parametrize("max_active", [0, 128])
def test_sampling_build_replays_jax_draws(sampling, max_active):
    """200 draws, the JAX package's indices replayed: three refreshes and
    the O(S) cache update between them."""
    A, b, valid = _sampling_problem()
    jc, tc = _consts("float32", A, b, sampling=sampling, valid=valid)
    fresh = lambda: jsn.init_state(jc, jax.random.key(5), max_active=max_active)  # noqa: E731
    draws = _jax_draws(fresh(), jc, 200)
    js = jsn.build(jc, fresh(), 200, 1e-6, method=sampling)     # build donates its state
    np.testing.assert_array_equal(np.bincount(draws, minlength=A.shape[1]), np.asarray(js.cts))
    ts = tsn.build(tc, tsn.init_state(tc, max_active), 200, 1e-6, method=sampling,
                   draws=Replay(draws))
    np.testing.assert_array_equal(ts.cts.numpy(), np.asarray(js.cts))
    _compare(js, ts, rtol=1e-5, atol=1e-6)
    # step by step equals in one go, and a carried state resumes
    half = jsn.build(jc, fresh(), 100, 1e-6, method=sampling)
    t2 = tsn.build(tc, interop.snnls_state(_np(half)), 100, 1e-6, method=sampling,
                   draws=Replay(draws[100:]))
    np.testing.assert_array_equal(t2.cts.numpy(), np.asarray(js.cts))
    _compare(js, t2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sampling", ["importance", "uniform"])
def test_sampling_overflow_latches_like_jax(sampling):
    """The (max_active+1)-th distinct atom is refused and latches ``done``;
    the counts, weights and image stay those of the draws before it."""
    A, b, valid = _sampling_problem()
    jc, tc = _consts("float32", A, b, sampling=sampling, valid=valid)
    draws = _jax_draws(jsn.init_state(jc, jax.random.key(1), max_active=4), jc, 50)
    js = jsn.build(jc, jsn.init_state(jc, jax.random.key(1), max_active=4), 50, 1e-6,
                   method=sampling)
    ts = tsn.build(tc, tsn.init_state(tc, 4), 50, 1e-6, method=sampling, draws=Replay(draws))
    assert bool(ts.done) and int(ts.itr) < 50 and int(ts.size) == 4
    np.testing.assert_array_equal(ts.cts.numpy(), np.asarray(js.cts))
    assert int(ts.cts.sum()) == int(ts.itr) - 1
    _compare(js, ts, rtol=1e-5, atol=1e-6)
    # a first draw that is refused leaves the state as it was found
    t0 = tsn.init_state(tc, 2)._replace(idcs=torch.tensor([0, 1], dtype=torch.int32),
                                        size=torch.tensor(2, dtype=torch.int32))
    t1 = tsn.build(tc, t0, 5, 1e-6, method=sampling, draws=Replay([9, 9]))
    assert bool(t1.done) and int(t1.itr) == 1 and not t1.w.any() and not t1.cts.any()


@pytest.mark.parametrize("sampling", ["importance", "uniform"])
def test_own_draws_follow_ps(sampling):
    """The port's own generator: over 4000 draws every frequency lies within
    4 standard errors of its probability."""
    A, b, valid = _sampling_problem(n=46)
    _, tc = _consts("float32", A, b, sampling=sampling, valid=valid)
    T = 4000
    ts = tsn.build(tc, tsn.init_state(tc, 0), T, 1e-6, method=sampling,
                   draws=torch.Generator().manual_seed(3))
    ps = tc.ps.double().numpy()
    freq = ts.cts.double().numpy() / T
    assert ts.cts.sum() == T and not ts.cts[~torch.as_tensor(valid)].any()
    se = np.sqrt(ps * (1 - ps) / T)
    assert (np.abs(freq - ps) <= 4 * se).all()
    w = ts.w.numpy()
    np.testing.assert_allclose(w[ps > 0], (freq / np.where(ps > 0, ps, 1))[ps > 0], rtol=1e-5)
    np.testing.assert_allclose(ts.xw.numpy(), A @ w, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# Facades
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", list(FACADES))
def test_facade_rejections_match_jax(method):
    """Zero columns: the greedy solvers reject them, the sampling solvers
    mask them.  A zero b: only GIGA rejects it."""
    J, T = FACADES[method]
    assert T.method == J.method == method
    A, b = _problem(S=32, n=64)
    Az = A.copy()
    Az[:, 5] = 0.0
    if method in ("importance", "uniform"):
        J(Az, b)
        t = T(Az, b)
        assert not bool(t.consts.valid[5]) and float(t.consts.ps[5]) == 0.0
    else:
        for cls in (J, T):
            with pytest.raises(ValueError):
                cls(Az, b)
        valid = np.ones(64, bool)
        valid[5] = False
        T(Az, b, valid=valid)                       # explicitly masked: allowed
    zero = np.zeros(32, np.float32)
    if method == "giga":
        with pytest.raises(NumericalPrecisionError):
            T(A, zero)
    else:
        J(A, zero)
        t = T(A, zero)
        t.build(3)
        assert np.isfinite(t.weights()).all() and np.isfinite(t.error())


@pytest.mark.parametrize("method", ["frankwolfe", "orthopursuit"])
def test_greedy_facade_matches_jax_facade(method):
    J, T = FACADES[method]
    A, b = _problem(8, S=64, n=300)
    j, t = J(A, b, max_active=64), T(A, b, max_active=64)
    n1, n2 = (30, 15) if method == "frankwolfe" else (8, 4)
    j.build(n1 + n2)
    t.build(n1)
    t.build(n2)                                     # incremental
    assert t.size() == j.size() > 0
    (ji, jw), (ti, tw) = j.active(), t.active()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, **TOL[method])
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)
    assert t.reached_numeric_limit == j.reached_numeric_limit
    w1 = t.weights()
    t.reset()
    assert t.size() == 0
    t.build(n1)
    t.build(n2)
    np.testing.assert_array_equal(t.weights(), w1)


@pytest.mark.parametrize("solver", ["fista", "exact"])
def test_optimize_after_frankwolfe_build(solver):
    A, b = _problem(9, S=64, n=300)
    j, t = jsn.FrankWolfe(A, b), tsn.FrankWolfe(A, b)
    j.build(40)
    t.build(40)
    e0 = t.error()
    j.optimize(solver=solver)
    t.optimize(solver=solver)
    assert not t.reached_numeric_limit and t.error() <= e0
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-3)
    np.testing.assert_array_equal(t.active()[0], j.active()[0])
    np.testing.assert_allclose(t.weights(), j.weights(), rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("method", ["importance", "uniform"])
def test_sampling_facade_seed_reset_optimize_checkpoint(method, tmp_path):
    _, T = FACADES[method]
    A, b, valid = _sampling_problem()
    t = T(A, b, valid=valid, seed=4, max_active=128)
    t.build(60)
    w60 = t.weights()
    assert float(t.state.cts.sum()) == 60 and t.size() == int((t.state.cts > 0).sum())
    assert (w60 >= 0).all() and np.isfinite(t.error())
    other = T(A, b, valid=valid, seed=5, max_active=128)
    other.build(60)
    assert not np.array_equal(other.weights(), w60)            # the seed matters
    again = T(A, b, valid=valid, seed=4, max_active=128)
    again.build(60)
    np.testing.assert_array_equal(again.weights(), w60)        # and determines
    t.reset()
    assert t.size() == 0 and not t.state.cts.any()
    t.build(60)
    np.testing.assert_array_equal(t.weights(), w60)            # reset() re-seeds

    # a checkpoint carries the generator: 60 + 40 draws equal 100 in one go
    path = str(tmp_path / "s.npz")
    t.save(path)
    t.build(40)
    resumed = T(A, b, valid=valid, seed=99, max_active=128)
    resumed.restore(path)
    np.testing.assert_array_equal(resumed.state.cts.numpy(), again.state.cts.numpy())
    resumed.build(40)
    np.testing.assert_array_equal(resumed.weights(), t.weights())
    np.testing.assert_array_equal(resumed.state.cts.numpy(), t.state.cts.numpy())
    # checkpointed builds fast-forward from the file, generator included
    ck = T(A, b, valid=valid, seed=4, max_active=128)
    ck.build(100, checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=30)
    np.testing.assert_array_equal(ck.weights(), t.weights())
    late = T(A, b, valid=valid, seed=123, max_active=128)
    late.build(100, checkpoint_path=str(tmp_path / "c.npz"))
    np.testing.assert_array_equal(late.weights(), t.weights())

    # optimize() re-solves the weights and leaves the counts alone
    cts, e0 = t.state.cts.clone(), t.error()
    t.optimize()
    assert torch.equal(t.state.cts, cts) and t.error() <= e0 * (1 + 1e-6)
    assert not np.array_equal(t.weights(), resumed.weights())


def test_greedy_checkpoint_round_trip(tmp_path):
    A, b = _problem(10, S=32, n=100)
    t = tsn.FrankWolfe(A, b, max_active=32)
    t.build(12, checkpoint_path=str(tmp_path / "fw.npz"), checkpoint_every=5)
    r = tsn.FrankWolfe(A, b, max_active=32)
    r.restore(str(tmp_path / "fw.npz"))
    assert int(r.state.itr) == 12 and r.state.cts.shape == (0,)
    np.testing.assert_array_equal(r.weights(), t.weights())


# ---------------------------------------------------------------------------
# HilbertCoreset(snnls=...)
# ---------------------------------------------------------------------------

HN, HD, HS, HM = 1500, 5, 64, 40


def _hilbert(method, n_subsample):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(HN, HD)).astype(np.float32)
    y = np.where(rng.uniform(size=HN) < 1 / (1 + np.exp(-x @ np.full(HD, 2.0))), 1.0, -1.0)
    z = (y[:, None] * x).astype(np.float32)
    th = (np.full(HD, 1.0) + 0.3 * rng.normal(size=(HS, HD))).astype(np.float32)
    J, T = FACADES[method]
    j = jbc.HilbertCoreset(z, jbc.BlackBoxProjector(lambda k, n, w, p: jnp.asarray(th), HS,
                                                    jlr.log_likelihood),
                           n_subsample=n_subsample, snnls=J, max_active=256, seed=2)
    t = tbc.HilbertCoreset(torch.as_tensor(z), tbc.BlackBoxProjector(
        lambda g, n, w, p: torch.as_tensor(th), HS, tlr.log_likelihood),
        n_subsample=n_subsample, snnls=T, max_active=256, seed=2)
    return j, t


@pytest.mark.parametrize("n_subsample", [None, 900])
@pytest.mark.parametrize("method", ["frankwolfe", "orthopursuit", "importance", "uniform"])
def test_hilbert_coreset_with_each_solver_matches_jax(method, n_subsample):
    j, t = _hilbert(method, n_subsample)
    assert isinstance(t.snnls, FACADES[method][1])
    M = 12 if method == "orthopursuit" else HM
    if method in ("importance", "uniform"):
        np.testing.assert_allclose(t.snnls.consts.ps.numpy(), np.asarray(j.snnls.consts.ps),
                                   rtol=1e-5, atol=1e-9)
        t.snnls._gen = Replay(_jax_draws(j.snnls.state, j.snnls.consts, M))
    j.build(M)
    t.build(M)
    (jw, jp, ji), (tw, tp, ti) = j.get(), t.get()
    assert ti.size > 0
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=1e-4)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)
    assert t.reached_numeric_limit == j.reached_numeric_limit
    if n_subsample is not None:
        np.testing.assert_array_equal(t.sub_idcs, j.sub_idcs)
