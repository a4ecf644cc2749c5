"""GIGA of the PyTorch port against the JAX package's ``snnls.build``.

Both run on the same numpy A, b.  The selected atoms (``state.idcs[:size]``)
must be identical; weights agree within rtol 1e-4, atol 1e-6, because the
port accumulates its O(S) dots in another order (in f64, rounded to f32).
Builds run 200 iterations: past three refreshes, with the wscale fold that
every first iteration takes (alpha == 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu_torch.ops import snnls as tsn
from bayesian_coresets_tpu_torch.utils import interop
from bayesian_coresets_tpu_torch.utils.errors import NumericalPrecisionError
from bayesian_coresets_tpu_torch.utils import config

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


def _port_vsel_for_jax(jc, tc):
    """The port's int8 copy, padded as the JAX package pads it."""
    q = tc.Vsel.numpy()
    out = np.zeros(jc.Vsel.shape, np.int8)
    out[:q.shape[0], :q.shape[1]] = q
    return jc._replace(Vsel=jnp.asarray(out))


def _consts(sd, A, b):
    jsd, tsd = SD[sd]
    jc = jsn.make_consts(A, b, select_dtype=jsd)
    tc = tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b), select_dtype=tsd)
    if sd == "int8":
        # both must select on the same bytes: the copies may differ by ±1
        # where the row norms (summed in another order) put an entry on a
        # rounding boundary
        jc = _port_vsel_for_jax(jc, tc)
    return jc, tc


@pytest.mark.parametrize("sd", list(SD))
def test_make_consts(sd):
    A, b = _problem()
    jsd, tsd = SD[sd]
    jc = jsn.make_consts(A, b, select_dtype=jsd)
    tc = tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b), select_dtype=tsd)
    np.testing.assert_allclose(tc.norms.numpy(), np.asarray(jc.norms), rtol=1e-6)
    np.testing.assert_allclose(float(tc.bnorm), float(jc.bnorm), rtol=1e-6)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    assert tc.Vsel.shape == (N, S_DIM) and tc.Vsel.dtype == (tsd or torch.float32)
    if sd == "int8":
        diff = np.asarray(jc.Vsel)[:N, :S_DIM].astype(int) - tc.Vsel.numpy().astype(int)
        assert np.abs(diff).max() <= 1
    elif sd == "bfloat16":
        np.testing.assert_array_equal(tc.Vsel.float().numpy(),
                                      np.asarray(jc.Vsel, np.float32)[:N, :S_DIM])
    else:
        assert tc.Vsel.data_ptr() == tc.V.data_ptr()      # f32 select aliases V


def test_make_consts_pads_columns_to_whole_16_byte_rows():
    A, b = _problem(S=30, n=40)
    for sd, width in [(torch.int8, 32), (torch.bfloat16, 32), (None, 32)]:
        c = tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b), select_dtype=sd)
        assert c.Vsel.shape == (40, width)
        assert not c.Vsel[:, 30:].any()


def _compare(js, ts, rtol=1e-4, atol=1e-6):
    k = int(js.size)
    assert int(ts.size) == k and int(ts.itr) == int(js.itr)
    assert bool(ts.done) == bool(js.done)
    np.testing.assert_array_equal(ts.idcs[:k].numpy(), np.asarray(js.idcs)[:k])
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ts.xw.numpy(), np.asarray(js.xw), rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("sd", list(SD))
def test_giga_build_matches_jax(sd):
    A, b = _problem()
    jc, tc = _consts(sd, A, b)
    js = jsn.build(jc, jsn.init_state(jc, max_active=256), 200, 1e-6)
    ts = tsn.build(tc, tsn.init_state(tc, 256), 200, 1e-6)
    assert int(js.itr) == 200 and not bool(js.done)
    _compare(js, ts)
    np.testing.assert_allclose(float(tsn.error(tc, ts.w)),
                               float(jsn.error(jc, js.w)), rtol=1e-4)


def test_giga_build_without_support_slots_matches_jax():
    """max_active=0: dense refresh, and the any(w > 0) monotone gate."""
    A, b = _problem(S=64, n=200)
    jc, tc = _consts("float32", A, b)
    js = jsn.build(jc, jsn.init_state(jc), 70, 1e-6)
    ts = tsn.build(tc, tsn.init_state(tc), 70, 1e-6)
    _compare(js, ts)


def test_resume_from_jax_state():
    """100 iterations in JAX, carried across, 100 more in the port, against
    200 in JAX."""
    A, b = _problem(1)
    jc, tc = _consts("int8", A, b)
    half = jsn.build(jc, jsn.init_state(jc, max_active=256), 100, 1e-6)
    half_np = _np(half)
    full = jsn.build(jc, jsn.init_state(jc, max_active=256), 200, 1e-6)
    tc2 = interop.snnls_consts(_np(jc))
    assert torch.equal(tc2.Vsel, tc.Vsel)
    ts = tsn.build(tc2, interop.snnls_state(half_np), 100, 1e-6)
    _compare(full, ts)


def test_interop_strips_jax_padding():
    A, b = _problem(S=100, n=300)
    jc = jsn.make_consts(A, b, select_dtype=jnp.bfloat16)
    assert jc.Vsel.shape == (1024, 128)
    tc = interop.snnls_consts(_np(jc))
    assert tc.Vsel.shape == (300, 104) and tc.Vsel.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.Vsel[:, :100].float().numpy(),
                                  np.asarray(jc.Vsel, np.float32)[:300, :100])
    f32 = interop.snnls_consts(_np(jsn.make_consts(A, b)))
    assert f32.Vsel.data_ptr() == f32.V.data_ptr()


def test_wscale_fold_step_matches_jax():
    """One step entered with a carried scale below the fold floor: the fold
    writes TRUE weights and resets the scale, as in the JAX package."""
    A, b = _problem(S=16, n=48)
    jc, tc = _consts("float32", A, b)
    js = jsn.build(jc, jsn.init_state(jc, max_active=16), 3, 1e-6)
    ws = jsn._WSCALE_FLOOR / 4.0
    w_true = np.asarray(js.w)
    xw = (A.astype(np.float64) @ w_true).astype(np.float32)
    raw_j = js._replace(w=js.w / ws, xw=jnp.asarray(xw))
    out = jsn._giga_step(jc, raw_j, jsn._aux_from_xw(jc, raw_j.xw, wscale=ws), 1e-6)

    raw_t = interop.snnls_state(_np(raw_j))
    aux_t = tsn._aux_from_xw(tc, raw_t.xw, wscale=ws)
    st = tsn._giga_step(tc, raw_t, aux_t, 1e-6)
    fold_commit = bool(st.fold & st.commit)
    assert fold_commit
    w2, xw2, _, _, aux2 = tsn._carried_commit(raw_t, st)
    assert float(aux2.wscale) == 1.0 == float(out[8].wscale)
    np.testing.assert_allclose(w2.numpy(), np.asarray(out[0]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xw2.numpy(), np.asarray(out[1]), rtol=1e-4, atol=1e-5)


def test_support_overflow_latches_like_jax():
    A, b = _problem(S=64, n=200)
    jc, tc = _consts("float32", A, b)
    js = jsn.build(jc, jsn.init_state(jc, max_active=8), 50, 1e-6)
    ts = tsn.build(tc, tsn.init_state(tc, 8), 50, 1e-6)
    assert bool(js.done) and bool(ts.done)
    _compare(js, ts)
    assert int((ts.w > 0).sum()) <= 8


def test_facade_matches_jax_facade():
    A, b = _problem(2, S=128, n=300)
    j = jsn.GIGA(A, b, select_dtype=jnp.bfloat16)
    t = tsn.GIGA(A, b, select_dtype=torch.bfloat16)
    j.build(60)
    t.build(40)
    t.build(20)                                     # incremental
    assert t.size() == j.size()
    ji, jw = j.active()
    ti, tw = t.active()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.weights(), j.weights(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.error(), j.error(), rtol=1e-4)
    assert t.reached_numeric_limit == j.reached_numeric_limit


def test_build_nonpositive_is_noop():
    A, b = _problem(S=32, n=64)
    t = tsn.GIGA(A, b)
    t.build(0)
    t.build(-5)
    assert int(t.state.itr) == 0 and t.size() == 0


def test_zero_column_rejected():
    A, b = _problem(S=32, n=64)
    A[:, 5] = 0.0
    with pytest.raises(ValueError):
        tsn.GIGA(A, b)
    valid = np.ones(64, bool)
    valid[5] = False
    tsn.GIGA(A, b, valid=valid)                    # explicitly masked: allowed


def test_zero_target_rejected():
    A, _ = _problem(S=32, n=64)
    with pytest.raises(NumericalPrecisionError):
        tsn.GIGA(A, np.zeros(32, np.float32))


def test_reset_rebuild_is_deterministic():
    A, b = _problem(3, S=64, n=128)
    t = tsn.GIGA(A, b, select_dtype=torch.int8)
    t.build(30)
    w1, i1 = t.weights(), t.active()[0]
    t.reset()
    assert t.size() == 0 and not t.reached_numeric_limit
    t.build(30)
    np.testing.assert_array_equal(t.weights(), w1)
    np.testing.assert_array_equal(t.active()[0], i1)


def test_build_leaves_its_input_state_unchanged():
    A, b = _problem(S=32, n=64)
    c = tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b))
    s0 = tsn.init_state(c, 16)
    s1 = tsn.build(c, s0, 10, 1e-6)
    assert not s0.w.any() and s1.w.any()
