"""The gated wscale fold (``ops/fold_scale.py``) on the CPU, where the
wrapper runs its plain version: against the JAX package's ``lax.cond`` in
``_carried_commit`` (ops/snnls.py:698 there) on the same numpy inputs, bit
for bit (both multiply every weight by the scale in f32, or leave it), and
the wrapper's checks.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu_torch.ops import fold_scale as fs

torch.set_num_threads(1)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 3.0, size=n).astype(np.float32)
    w[rng.uniform(size=n) < 0.5] = 0.0
    return w


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("n", [1, 7, 48, 1025])
def test_fold_matches_jax_carried_commit(n, fold):
    """The JAX package's _carried_commit with commit set and the scale below
    (fold) or above the floor: its weights are the port's fold followed by
    the one-index write, bit for bit."""
    w = _inputs(n, seed=n)
    f, new_wf = n // 2, np.float32(1.25)
    ws, alpha = np.float32(1.0), np.float32(jsn._WSCALE_FLOOR / 4 if fold else 0.5)
    ws2 = np.float32(alpha * ws)
    out = jsn._carried_commit(
        jsn.SNNLSState(w=jnp.asarray(w), xw=jnp.zeros(4), cts=jnp.zeros(0),
                       idcs=jnp.zeros(0, jnp.int32), size=jnp.int32(0), itr=jnp.int32(0),
                       fail=jnp.int32(0), done=jnp.bool_(False), key=None),
        jsn.GigaAux(*(jnp.float32(1.0) for _ in jsn.GigaAux._fields)), jnp.int32(f),
        jnp.float32(alpha), jnp.float32(ws), jnp.float32(w[f]), jnp.float32(new_wf), jnp.zeros(4), jnp.bool_(True), jnp.bool_(True), jnp.bool_(False),
        jnp.zeros(0, jnp.int32), jnp.int32(0))
    jw = np.asarray(out[0])
    tw = torch.as_tensor(w.copy())
    fs.fold_scale(tw, torch.tensor(bool(ws2 < jsn._WSCALE_FLOOR)), torch.tensor(ws2))
    raw = new_wf if fold else np.float32(new_wf / ws2)
    tw[f] = float(raw)
    np.testing.assert_array_equal(tw.numpy().view(np.int32), jw.view(np.int32))


@pytest.mark.parametrize("flag", [True, False])
def test_plain_version_is_one_multiply_or_none(flag):
    """Set: every weight times the scale, as ``w * scale`` gives it; clear:
    every bit as it was (-0.0, inf and nan included)."""
    w = torch.tensor([0.0, -0.0, 1.5, 3.0e-39, float("inf"), float("nan"), 7.0])
    ref = w * 0.25 if flag else w.clone()
    out = fs.fold_scale(w, torch.tensor(flag), torch.tensor(0.25))
    assert out is w
    assert torch.equal(w.view(torch.int32), ref.view(torch.int32))
    assert fs.launches == 0                      # the plain version is no launch


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "flag", "scale"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    w, flag, scale = torch.ones(8), torch.tensor(True), torch.tensor(0.5)
    if bad == "dtype":
        w = w.double()
    elif bad == "shape":
        w = w.view(2, 4)
    elif bad == "stride":
        w = torch.ones(16)[::2]
    elif bad == "flag":
        flag = torch.tensor(1.0)
    else:
        scale = torch.tensor([0.5])
    with pytest.raises(ValueError):
        fs.fold_scale(w, flag, scale)
