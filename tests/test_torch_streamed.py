"""The streamed int8-resident Hilbert construction of the PyTorch port
against the JAX package's (``HilbertCoreset(stream_chunk_size=...)``), and
the phase timers of ``utils/profiling.py``.

Both sides project the same logistic data (N=400 in chunks of 128: four
chunks, the last one partial) against the same numpy-made θ samples.  The
int8 rows must be equal except ±1 where 127 v/|v| lies on a rounding
boundary (counted: 0 on these data), the norms within rtol 1e-6 and b
within rtol 1e-5; the builds must select the same atoms, with weights and
error() within rtol 1e-4.
"""

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
from bayesian_coresets_tpu_torch.parallel import streamed as tst
from bayesian_coresets_tpu_torch.utils import config, profiling

from test_torch_solvers import Replay, _jax_draws

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Numpy data, and the generators the entry points make, go to the CPU."""
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


N, D, S, CHUNK, M = 400, 5, 64, 128, 100
FACADES = {"giga": (jsn.GIGA, tsn.GIGA), "frankwolfe": (jsn.FrankWolfe, tsn.FrankWolfe),
           "orthopursuit": (jsn.OrthoPursuit, tsn.OrthoPursuit),
           "importance": (jsn.ImportanceSampling, tsn.ImportanceSampling),
           "uniform": (jsn.UniformSampling, tsn.UniformSampling)}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = np.where(rng.uniform(size=N) < 1 / (1 + np.exp(-x @ np.full(D, 2.0))), 1.0, -1.0)
    z = (y[:, None] * x).astype(np.float32)
    th = (np.full(D, 1.0) + 0.3 * rng.normal(size=(S, D))).astype(np.float32)
    return z, th


def _projectors(th):
    return (jbc.BlackBoxProjector(lambda k, n, w, p: jnp.asarray(th), S, jlr.log_likelihood),
            tbc.BlackBoxProjector(lambda g, n, w, p: torch.as_tensor(th), S, tlr.log_likelihood))


def _streamed(method="giga", seed=0, max_active=256, data=None):
    z, th = _data(seed)
    jp, tp = _projectors(th)
    J, T = FACADES[method]
    j = jbc.HilbertCoreset(z, jp, snnls=J, stream_chunk_size=CHUNK, max_active=max_active,
                           seed=seed)
    t = tbc.HilbertCoreset(z if data is None else data(z), tp, snnls=T,
                           stream_chunk_size=CHUNK, max_active=max_active, seed=seed)
    return j, t, z


def test_streamed_constants_match_jax():
    j, t, _ = _streamed()
    jc, tc = j.snnls.consts, t.snnls.consts
    assert tc.V.dtype == torch.int8 and tc.V.shape == (N, S) and tc.Vsel is tc.V
    assert jc.V.shape == (1024, 128)
    d = np.asarray(jc.V)[:N, :S].astype(np.int32) - tc.V.numpy().astype(np.int32)
    assert np.abs(d).max() <= 1 and np.count_nonzero(d) == 0
    np.testing.assert_allclose(tc.norms.numpy(), np.asarray(jc.norms)[:N], rtol=1e-6)
    np.testing.assert_allclose(tc.b.numpy(), np.asarray(jc.b)[:S], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tc.bnorm), float(jc.bnorm), rtol=1e-6)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid)[:N])
    assert isinstance(t.data, np.ndarray)                 # the data stayed on the host


def test_streamed_rows_equal_one_quantization_of_the_whole_projection():
    """Chunking changes nothing: the rows, norms and b equal those of one
    quantize_chunk over the whole projection (tests/test_coresets.py:425-441)."""
    _, t, z = _streamed()
    vecs = _projectors(_data()[1])[1].project(torch.as_tensor(z))
    q, nrm, bsum = tst.quantize_chunk(vecs, N)
    c = t.snnls.consts
    assert torch.equal(c.V, q) and torch.equal(c.norms, nrm)
    np.testing.assert_allclose(c.b.numpy(), bsum.numpy(), rtol=1e-6, atol=1e-6)


def test_streamed_build_matches_jax():
    j, t, z = _streamed()
    j.build(M)
    t.build(M)
    (jw, jp, ji), (tw, tp, ti) = j.get(), t.get()
    assert ti.size > 10
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=1e-4)
    np.testing.assert_array_equal(tp, z[ti])
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)
    assert t.reached_numeric_limit == j.reached_numeric_limit


def test_streamed_incremental_build_continues():
    _, t, _ = _streamed(seed=1)
    _, once, _ = _streamed(seed=1)
    t.build(20)
    e20 = t.error()
    t.build(30)
    assert 0.0 <= t.error() < e20
    once.build(50)
    np.testing.assert_array_equal(t.get()[2], once.get()[2])
    # the carried weight scale folds in at each build's return
    np.testing.assert_allclose(t.get()[0], once.get()[0], rtol=1e-5)
    t.reset()
    assert t.get()[0].size == 0
    t.build(20)
    np.testing.assert_allclose(t.error(), e20, rtol=1e-6)


def test_streamed_from_a_cpu_tensor():
    """A CPU tensor streams as numpy does, and get() reads its rows."""
    _, t, z = _streamed(data=torch.as_tensor)
    _, ref, _ = _streamed()
    assert torch.equal(t.snnls.consts.V, ref.snnls.consts.V)
    t.build(30)
    ref.build(30)
    w, p, i = t.get()
    np.testing.assert_array_equal(i, ref.get()[2])
    np.testing.assert_array_equal(p, z[i])


def test_streamed_rejects_subsample_and_a_resampling_projector():
    z, th = _data()
    _, tp = _projectors(th)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tbc.HilbertCoreset(z, tp, n_subsample=100, stream_chunk_size=CHUNK)
    with pytest.raises(ValueError, match="positive"):
        tbc.HilbertCoreset(z, tp, stream_chunk_size=0)

    class Resampling(tbc.coresets.projector.Projector):
        """Draws new samples inside every project() call."""

        def __init__(self):
            self.gen = torch.Generator().manual_seed(0)

        def project(self, pts, grad=False):
            th_now = torch.randn((S, D), generator=self.gen)
            return tlr.log_likelihood(torch.as_tensor(pts), th_now)

        def update(self, wts, pts):
            pass

    with pytest.raises(ValueError, match="fixed context"):
        tbc.HilbertCoreset(z, Resampling(), stream_chunk_size=CHUNK)


@pytest.mark.parametrize("method", ["frankwolfe", "orthopursuit", "importance", "uniform"])
def test_every_solver_through_the_streamed_facade(method):
    """The other four solvers built from the streamed constants select as
    the JAX package's do (the sampling solvers with its draws replayed)."""
    j, t, z = _streamed(method)
    assert isinstance(t.snnls, FACADES[method][1])
    itrs = 12 if method == "orthopursuit" else 40
    if method in ("importance", "uniform"):
        np.testing.assert_allclose(t.snnls.consts.ps.numpy(),
                                   np.asarray(j.snnls.consts.ps)[:N], rtol=1e-5, atol=1e-9)
        t.snnls._gen = Replay(_jax_draws(j.snnls.state, j.snnls.consts, itrs))
    e0 = t.error()
    j.build(itrs)
    t.build(itrs)
    (jw, _, ji), (tw, tp, ti) = j.get(), t.get()
    assert ti.size > 0 and (tw > 0).all() and ti.max() < N
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=1e-4)
    np.testing.assert_array_equal(tp, z[ti])
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)
    if method in ("frankwolfe", "orthopursuit"):
        assert t.error() < e0


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_profiling_phases_count_total_and_reset():
    profiling.reset()
    x = torch.ones(3)
    for _ in range(3):
        with profiling.phase("build", sync=x):
            torch.ones(10).sum()
    with profiling.phase("construct", sync=(x, None)):
        pass
    with pytest.raises(RuntimeError):
        with profiling.phase("fails"):
            raise RuntimeError("boom")
    rep = profiling.report()
    assert set(rep) == {"build", "construct", "fails"}
    assert rep["build"]["count"] == 3 and rep["construct"]["count"] == 1
    assert rep["build"]["total_s"] >= 0.0
    np.testing.assert_allclose(rep["build"]["mean_s"], rep["build"]["total_s"] / 3)
    profiling.reset()
    assert profiling.report() == {}
