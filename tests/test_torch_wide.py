"""GIGA and Frank-Wolfe of the PyTorch port against the JAX package's at a
wide projection: S=12289 samples, an f32 select copy whose rows (49168
bytes, padded to 12292 columns) are past the ring kernel's 48 KB, so on a
card they select through the wide-row kernel.  Here, on the CPU, the port
selects through the plain version.  The same numpy A, b go to both; the
selected atoms must be identical and the weights agree within rtol 1e-4
(tests/test_torch_snnls.py's ``_compare``).
"""

import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu_torch.ops import snnls as tsn
from bayesian_coresets_tpu_torch.utils import config

torch.set_num_threads(1)

S_WIDE, N_WIDE, M_WIDE = 12289, 64, 20


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    config.set_default_device("cpu")
    yield
    config.set_default_device(None)


def _compare(js, ts, rtol=1e-4, atol=1e-6):
    k = int(js.size)
    assert int(ts.size) == k and int(ts.itr) == int(js.itr)
    assert bool(ts.done) == bool(js.done)
    np.testing.assert_array_equal(ts.idcs[:k].numpy(), np.asarray(js.idcs)[:k])
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ts.xw.numpy(), np.asarray(js.xw), rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("method", ["giga", "frankwolfe"])
def test_wide_projection_build_matches_jax(method):
    rng = np.random.default_rng(12)
    A = rng.normal(size=(S_WIDE, N_WIDE)).astype(np.float32)
    b = A[:, : N_WIDE // 2].sum(axis=1)
    jc = jsn.make_consts(A, b)
    tc = tsn.make_consts(torch.as_tensor(A), torch.as_tensor(b))
    row_bytes = tc.Vsel.shape[1] * tc.Vsel.element_size()
    assert tc.Vsel.dtype == torch.float32 and row_bytes > 48 * 1024
    js = jsn.build(jc, jsn.init_state(jc, max_active=N_WIDE), M_WIDE, 1e-6, method=method)
    ts = tsn.build(tc, tsn.init_state(tc, N_WIDE), M_WIDE, 1e-6, method=method)
    assert int(js.itr) == M_WIDE and not bool(js.done)
    _compare(js, ts)
    np.testing.assert_allclose(float(tsn.error(tc, ts.w)), float(jsn.error(jc, js.w)),
                               rtol=1e-4)
