"""int8-resident constants of the PyTorch port against the JAX package:
``quantize_chunk``, ``make_consts_quantized``, the five solvers through
``from_consts``, ``error(support=)``, the overflow latch, both ``optimize``
solvers, and JAX int8-resident constants carried through ``interop``.

Both sides take the same numpy inputs.  int8 rows must be equal except ±1
where 127 v/|v| lies on a rounding boundary (counted, and 0 on these data).
GIGA, Frank-Wolfe and OMP must select the same atoms in the same order over
80 iterations, with weights within rtol 1e-4 (O(S) dots summed in f64 here,
in f32 there; OMP's FISTA products in another order).  That comparison runs
at S=128, n=300: on tests/test_snnls.py:260-283's S=40 problem the builds
take more atoms than S within 80 iterations, the residual b - xw then lies at
rounding level, and its direction (which the f64 sums here and the f32 sums
there round differently) no longer decides the next atom; there the port is
held to the JAX package's own rule instead (the error within 2x of the f32
solver's, or 5% of the initial error).  The sampling solvers replay the
indices ``jax.random`` drew.  The JAX package pads rows to a 1024
multiple and columns to 128; the port pads columns to 16 only, so the
comparisons take the first n rows and S columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu.parallel import streamed as jst
from bayesian_coresets_tpu_torch.ops import snnls as tsn
from bayesian_coresets_tpu_torch.parallel import streamed as tst
from bayesian_coresets_tpu_torch.utils import config, interop

from test_torch_solvers import Replay, _jax_draws

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


S_DIM, N = 40, 300
S_STEP = 128            # the step-for-step comparison's S (see above)
ITRS = 80
CLASSES = {"giga": (jsn.GIGA, tsn.GIGA), "frankwolfe": (jsn.FrankWolfe, tsn.FrankWolfe),
           "orthopursuit": (jsn.OrthoPursuit, tsn.OrthoPursuit),
           "importance": (jsn.ImportanceSampling, tsn.ImportanceSampling),
           "uniform": (jsn.UniformSampling, tsn.UniformSampling)}
RTOL = {"giga": 1e-4, "frankwolfe": 1e-4, "orthopursuit": 1e-4}


def _problem(seed=0, S=S_DIM, n=N):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    return A, A.sum(axis=1)


def _quantize_rows(A):
    """Host quantization (tests/test_snnls.py:251-257): V's rows normalized
    and scaled to ±127."""
    V = A.T
    norms = np.sqrt((V**2).sum(axis=1))
    safe = np.where(norms > 0, norms, 1.0)
    Vq = np.clip(np.round(V / safe[:, None] * 127.0), -127, 127).astype(np.int8)
    return Vq, norms.astype(np.float32)


def _sampling(method):
    return method if method in ("importance", "uniform") else None


def _consts(A, b, method="giga", valid=None):
    Vq, norms = _quantize_rows(A)
    jc = jsn.make_consts_quantized(jnp.asarray(Vq), jnp.asarray(norms), jnp.asarray(b),
                                   valid=None if valid is None else jnp.asarray(valid),
                                   sampling=_sampling(method))
    tc = tsn.make_consts_quantized(torch.as_tensor(Vq), torch.as_tensor(norms),
                                   torch.as_tensor(b),
                                   valid=None if valid is None else torch.as_tensor(valid),
                                   sampling=_sampling(method))
    return jc, tc, Vq, norms


def _rows_differ(a, b):
    """How many int8 entries differ; every difference must be ±1."""
    d = np.asarray(a, np.int32) - np.asarray(b, np.int32)
    assert np.abs(d).max(initial=0) <= 1
    return int(np.count_nonzero(d))


def _compare(j, t, n, rtol):
    """Two facades' states: the same slots in the same order, flags and
    counts equal, weights within ``rtol``."""
    js, ts = j.state, t.state
    k = int(js.size)
    assert (int(ts.size), int(ts.itr), int(ts.fail), bool(ts.done)) == \
        (k, int(js.itr), int(js.fail), bool(js.done))
    np.testing.assert_array_equal(ts.idcs[:k].numpy(), np.asarray(js.idcs)[:k])
    np.testing.assert_allclose(ts.w.numpy()[:n], np.asarray(js.w)[:n], rtol=rtol, atol=1e-6)
    assert not np.asarray(js.w)[n:].any()
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)


# ---------------------------------------------------------------------------
# quantize_chunk and make_consts_quantized
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("live", [96, 70])
def test_quantize_chunk_matches_jax(live):
    C = 96
    rng = np.random.default_rng(1)
    vecs = (rng.normal(size=(C, S_DIM)) * rng.uniform(0.1, 5.0, size=(C, 1))).astype(np.float32)
    vecs[5] = 0.0                                      # a zero row: norm 0, int8 row 0
    jq, jn, jb = (np.asarray(x) for x in jst.quantize_chunk(jnp.asarray(vecs), jnp.int32(live)))
    tq, tn, tb = tst.quantize_chunk(torch.as_tensor(vecs), live)
    assert tq.dtype == torch.int8 and tq.shape == (C, S_DIM) and tn.shape == (C,)
    assert _rows_differ(tq.numpy(), jq) == 0
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), vecs[:live].astype(np.float64).sum(axis=0), rtol=1e-12)
    assert not tq[live:].any() and not tn[live:].any() and float(tn[5]) == 0.0
    # the live nonzero rows are unit vectors on the ±127 scale
    unit = np.linalg.norm(tq[:live].double().numpy() / 127.0, axis=1)
    np.testing.assert_allclose(np.delete(unit, 5), 1.0, atol=0.02)


@pytest.mark.parametrize("method", ["giga", "importance", "uniform"])
def test_make_consts_quantized_matches_jax(method):
    A, b = _problem()
    A[:, 17] = 0.0                                     # a zero row of V: invalid
    valid = np.ones(N, bool)
    valid[[3, 250]] = False
    jc, tc, Vq, _ = _consts(A, b, method, valid=valid)
    assert tc.V.dtype == torch.int8 and tc.V.shape == (N, 48)       # 40 -> 48 columns
    assert tc.Vsel is tc.V and jc.V.shape == (1024, 128) and jc.Vsel.shape[0] == 0
    np.testing.assert_array_equal(tc.V[:, :S_DIM].numpy(), np.asarray(jc.V)[:N, :S_DIM])
    assert not tc.V[:, S_DIM:].any() and not tc.b[S_DIM:].any()
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid)[:N])
    assert not np.asarray(jc.valid)[N:].any()
    assert not bool(tc.valid[17]) and not bool(tc.valid[3]) and float(tc.norms[17]) == 1.0
    np.testing.assert_allclose(tc.norms.numpy(), np.asarray(jc.norms)[:N], rtol=1e-6)
    np.testing.assert_allclose(float(tc.bnorm), float(jc.bnorm), rtol=1e-6)
    if method == "giga":
        assert tc.ps.shape == (0,) and jc.ps.shape == (0,)
    else:
        np.testing.assert_allclose(tc.ps.numpy(), np.asarray(jc.ps)[:N], rtol=1e-5, atol=1e-9)
    st = tsn.init_state(tc, 8)
    assert st.w.dtype == st.xw.dtype == torch.float32 and st.xw.shape == (48,)


def test_make_consts_quantized_never_copies_a_padded_buffer():
    Vq = torch.randint(-127, 128, (50, 32), dtype=torch.int8)
    c = tsn.make_consts_quantized(Vq, torch.ones(50), torch.ones(20))
    assert c.V.data_ptr() == Vq.data_ptr() and c.Vsel is c.V and c.b.shape == (32,)
    with pytest.raises(ValueError):
        tsn.make_consts_quantized(Vq.float(), torch.ones(50), torch.ones(20))


# ---------------------------------------------------------------------------
# the five solvers through from_consts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["giga", "frankwolfe", "orthopursuit"])
def test_greedy_solver_from_consts_matches_jax(method):
    """80 iterations step for step, while the builds hold fewer atoms than S."""
    J, T = CLASSES[method]
    A, b = _problem(S=S_STEP)
    jc, tc, _, _ = _consts(A, b)
    j = J.from_consts(jc, max_active=512)
    t = T.from_consts(tc, max_active=512)
    e0 = t.error()
    np.testing.assert_allclose(e0, j.error(), rtol=1e-6)
    j.build(ITRS)
    t.build(ITRS)
    assert int(t.state.itr) == ITRS and 60 < t.size() < S_STEP
    _compare(j, t, N, RTOL[method])
    assert t.error() < e0


@pytest.mark.parametrize("method", list(CLASSES))
def test_quantized_mode_converges_as_jax_requires(method):
    """tests/test_snnls.py:260-283 on the port: S=40, n=300, 80 iterations
    from int8-resident constants; padded rows are never selected."""
    J, T = CLASSES[method]
    A, b = _problem(1)
    _, tc, _, _ = _consts(A, b, method)
    t = T.from_consts(tc, max_active=512)
    e0 = t.error()
    t.build(ITRS)
    w = t.weights()
    assert w.shape == (N,) and (w >= 0).all()
    if method in ("giga", "frankwolfe", "orthopursuit"):
        assert t.error() < e0
        ref = T(A, b, max_active=512)
        ref.build(ITRS)
        assert t.error() < max(2.0 * ref.error(), 0.05 * e0)
    else:
        t.build(2000)
        assert t.error() < e0


@pytest.mark.parametrize("method", ["importance", "uniform"])
def test_sampling_from_consts_replays_jax_draws(method):
    J, T = CLASSES[method]
    A, b = _problem(2)
    A *= np.random.default_rng(2).uniform(0.2, 3.0, size=N).astype(np.float32)
    jc, tc, _, _ = _consts(A, b, method)
    j = J.from_consts(jc, seed=3, max_active=256)
    t = T.from_consts(tc, seed=3, max_active=256)
    t._gen = Replay(_jax_draws(j.state, jc, 200))
    j.build(200)
    t.build(200)
    np.testing.assert_array_equal(t.state.cts.numpy(), np.asarray(j.state.cts)[:N])
    _compare(j, t, N, 1e-5)
    np.testing.assert_allclose(t.state.xw.numpy()[:S_DIM], np.asarray(j.state.xw)[:S_DIM],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", list(CLASSES))
def test_from_consts_reset_checkpoint_and_mesh(method, tmp_path):
    """``reset``, ``save``/``restore`` and the sampling generator work as
    for the classes' own constructor; ``mesh=`` takes a ``parallel.make_mesh``
    mesh (tests/test_torch_parallel.py drives it) and refuses anything else."""
    _, T = CLASSES[method]
    A, b = _problem(4, S=24, n=120)
    _, tc, _, _ = _consts(A, b, method)
    t = T.from_consts(tc, seed=7, max_active=64)
    t.build(30)
    w30 = t.weights()
    path = str(tmp_path / "s.npz")
    t.save(path)
    t.build(20)
    w50 = t.weights()
    r = T.from_consts(tc, seed=99, max_active=64)
    r.restore(path)
    np.testing.assert_array_equal(r.weights(), w30)
    r.build(20)
    np.testing.assert_array_equal(r.weights(), w50)      # the generator came along
    t.reset()
    assert t.size() == 0
    t.build(30)
    np.testing.assert_array_equal(t.weights(), w30)      # reset() re-seeds
    with pytest.raises(ValueError, match="parallel.make_mesh"):
        T.from_consts(tc, mesh=object())


def test_giga_from_consts_rejects_a_zero_b():
    A, _ = _problem(S=16, n=40)
    _, tc, _, _ = _consts(A, np.zeros(16, np.float32))
    with pytest.raises(tsn.NumericalPrecisionError):
        tsn.GIGA.from_consts(tc)
    tsn.FrankWolfe.from_consts(tc).build(3)


# ---------------------------------------------------------------------------
# dequantized reads: error(support=), the latch, optimize()
# ---------------------------------------------------------------------------

def test_error_on_support_equals_dense_dequantized():
    """tests/test_snnls.py:286-300: with nnz(w) <= k, error(support=k) is
    the dense dequantized residual, and so is JAX's."""
    rng = np.random.default_rng(5)
    A, b = _problem(5, S=16, n=100)
    jc, tc, Vq, norms = _consts(A, b)
    w = np.zeros(100, np.float32)
    idx = rng.choice(100, size=7, replace=False)
    w[idx] = rng.uniform(0.5, 2.0, size=7).astype(np.float32)
    Vdeq = Vq.astype(np.float64) * (norms[:, None] / 127.0)
    want = np.linalg.norm(Vdeq.T @ w - np.asarray(b, np.float64))
    got = float(tsn.error(tc, torch.as_tensor(w), support=16))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jw = np.zeros(jc.V.shape[0], np.float32)
    jw[:100] = w
    np.testing.assert_allclose(got, float(jsn.error(jc, jnp.asarray(jw), support=16)), rtol=1e-5)
    # a support below nnz(w) leaves the smallest weights out, as JAX's top-k does
    got3 = float(tsn.error(tc, torch.as_tensor(w), support=3))
    np.testing.assert_allclose(got3, float(jsn.error(jc, jnp.asarray(jw), support=3)), rtol=1e-5)
    assert got3 > got
    # the rows: dequantized on read
    fl = torch.tensor([int(idx[0])])
    np.testing.assert_allclose(tsn._v_row(tc, fl).numpy()[:16], Vdeq[idx[0]], rtol=1e-6)


def test_overflow_latch_with_int8_resident_consts():
    """tests/test_snnls.py:346-360: identity columns, max_active=4."""
    A = np.eye(16, dtype=np.float32)
    b = A.sum(axis=1)
    jc, tc, Vq, norms = _consts(A, b)
    j = jsn.GIGA.from_consts(jc, max_active=4)
    t = tsn.GIGA.from_consts(tc, max_active=4)
    j.build(16)
    t.build(16)
    assert t.reached_numeric_limit and j.reached_numeric_limit
    w = t.weights()
    assert (w > 0).sum() <= 4
    Vdeq = Vq.astype(np.float64) * (norms[:, None] / 127.0)
    want = np.linalg.norm(Vdeq.T @ w - b.astype(np.float64))
    np.testing.assert_allclose(t.error(), want, rtol=1e-4, atol=1e-4)
    _compare(j, t, 16, 1e-5)
    t.build(10)                                        # latched: a no-op
    np.testing.assert_array_equal(t.weights(), w)


@pytest.mark.parametrize("solver", ["fista", "exact"])
def test_optimize_on_int8_rows_matches_jax(solver):
    """tests/test_snnls.py:303-316: a GIGA build of 40, then the re-solve on
    the dequantized active rows (S=64, so that 40 atoms leave a residual
    above rounding level to compare)."""
    A, b = _problem(6, S=64, n=300)
    jc, tc, _, _ = _consts(A, b)
    j = jsn.GIGA.from_consts(jc, max_active=256)
    t = tsn.GIGA.from_consts(tc, max_active=256)
    j.build(40)
    t.build(40)
    e0 = t.error()
    j.optimize(solver=solver)
    t.optimize(solver=solver)
    assert not t.reached_numeric_limit and t.error() <= e0 * (1.0 + 1e-5)
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-3)
    ta, ja = t.active(), j.active()
    np.testing.assert_array_equal(ta[0], ja[0])
    np.testing.assert_allclose(ta[1], ja[1], rtol=2e-3, atol=1e-4)
    # the cached image follows the new weights (ROADMAP Queue 3 (f))
    Vdeq = tc.V[:, :64].double() * (tc.norms.double()[:, None] / 127.0)
    np.testing.assert_allclose(t.state.xw[:64].numpy(), (t.state.w.double() @ Vdeq).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_dense_refresh_without_slots_matches_jax():
    """max_active=0: the refresh is ``_v_matvec`` over the top ``matvec_k``
    weights; with matvec_k=0 it is empty in both packages."""
    A, b = _problem(7, S=24, n=90)
    jc, tc, _, _ = _consts(A, b)
    for k in (1024, 0):
        js = jsn.build(jc, jsn.init_state(jc), 70, 1e-6, method="frankwolfe", matvec_k=k)
        ts = tsn.build(tc, tsn.init_state(tc), 70, 1e-6, method="frankwolfe", matvec_k=k)
        assert (int(ts.itr), bool(ts.done)) == (int(js.itr), bool(js.done))
        np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w)[:90], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ts.xw.numpy()[:24], np.asarray(js.xw)[:24], rtol=1e-4,
                                   atol=1e-4)


def test_jax_int8_resident_consts_through_interop():
    """JAX constants (rows padded to 1024, columns to 128) carried across
    keep their padding, and the build selects as JAX's does."""
    A, b = _problem(8)
    jc, tc, _, _ = _consts(A, b)
    c = interop.snnls_consts(type(jc)(*map(np.asarray, jc)))
    assert c.V.dtype == torch.int8 and c.V.shape == (1024, 128) and c.Vsel is c.V
    assert not bool(c.valid[N:].any())
    js = jsn.build(jc, jsn.init_state(jc, max_active=256), 60, 1e-6, method="giga")
    ts = tsn.build(c, tsn.init_state(c, 256), 60, 1e-6, method="giga")
    k = int(js.size)
    assert int(ts.size) == k > 10
    np.testing.assert_array_equal(ts.idcs[:k].numpy(), np.asarray(js.idcs)[:k])
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=1e-4, atol=1e-6)
    # the port's own int8-resident constants round-trip too
    c2 = interop.snnls_consts(type(tc)(*(x.numpy() for x in tc)))
    assert torch.equal(c2.V, tc.V) and c2.Vsel is c2.V and torch.equal(c2.b, tc.b)
