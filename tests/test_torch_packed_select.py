"""Packed-int4 select (the probe's kernel 2) of the PyTorch port against the
JAX package's Pallas kernel.

The JAX kernel lives in ``scripts/probe_int4_pallas.py``, loaded here by
path and run in Pallas interpret mode on the CPU, as the JAX package's own
Pallas tests run.  Both sides get the same numpy inputs.  The dots are exact
integers on both sides, so the index must be identical; the score agrees to
f32 rounding (rtol 1e-6).  The CUDA kernel itself is checked against the
plain version only on a card, in tests/test_torch_cuda.py (marker ``cuda``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesian_coresets_tpu_torch.ops import packed_select as ps
from bayesian_coresets_tpu_torch.utils import interop

torch.set_num_threads(1)

N, S, TILE = 8192, 64, 4096          # the JAX kernel needs N % TILE == 0
CASES = ["random", "invalid_tile", "ties_across_tiles", "all_invalid", "row_scales"]


@pytest.fixture(scope="module")
def probe():
    path = Path(__file__).resolve().parents[1] / "scripts" / "probe_int4_pallas.py"
    spec = importlib.util.spec_from_file_location("probe_int4_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(case, n=N, seed=0):
    """(q (n, S) int8 nibbles, dirs2 (S, 2), nrminv (n,), bias (n,)) as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-7, 8, size=(n, S)).astype(np.int8)
    dirs = rng.uniform(-0.04, 0.04, size=(S, 2)).astype(np.float32)
    nrminv = np.ones(n, np.float32)
    bias = np.zeros(n, np.float32)
    if case == "invalid_tile":
        best = _numpy_select(q, dirs, nrminv, bias)[0]
        bias[best // TILE * TILE: best // TILE * TILE + TILE] = -np.inf
    elif case == "ties_across_tiles":
        best = _numpy_select(q, dirs, nrminv, bias)[0]
        q[[best % TILE, TILE + best % TILE, n - 1]] = q[best]   # a copy in each tile
    elif case == "all_invalid":
        bias[:] = -np.inf
    elif case == "row_scales":
        nrminv = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        bias = rng.normal(scale=0.1, size=n).astype(np.float32)
    return q, dirs, nrminv, bias


def _numpy_select(q, dirs, nrminv, bias):
    """Index and score from unpacked integer dots (int64), numpy f32 epilogue."""
    Sq = np.clip(np.round(dirs * np.float32(127.0)), -127, 127).astype(np.int64)
    acc = q[:, 0::2].astype(np.int64) @ Sq[0::2] + q[:, 1::2].astype(np.int64) @ Sq[1::2]
    dots = acc.astype(np.float32) * np.float32(1.0 / (7.0 * 127.0))
    d0, d1 = dots[:, 0] * nrminv, dots[:, 1] * nrminv
    score = d0 / np.sqrt(np.maximum(np.float32(1.0) - d1 * d1, np.float32(1e-30))) + bias
    f = int(np.argmax(score))
    return f, float(score[f])


def _port(q, dirs, nrminv, bias):
    P = ps.pack_int4(torch.as_tensor(q))
    i, s = ps.packed_select(P, torch.as_tensor(dirs), torch.as_tensor(nrminv),
                            torch.as_tensor(bias))
    assert i.dtype == torch.int32 and s.dtype == torch.float32
    return int(i), float(s)


@pytest.mark.parametrize("case", CASES)
def test_plain_select_matches_pallas_kernel(probe, case):
    q, dirs, nrminv, bias = _inputs(case)
    P = ps.pack_int4(torch.as_tensor(q)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ji, js = probe.packed_select(jnp.asarray(P), jnp.asarray(dirs), jnp.asarray(nrminv),
                                     jnp.asarray(bias), tile_rows=TILE)
    ji, js = int(ji), float(js)
    pi, pscore = _port(q, dirs, nrminv, bias)
    assert pi == ji
    if case == "all_invalid":
        assert (pi, pscore, js) == (0, -np.inf, -np.inf)
    else:
        np.testing.assert_allclose(pscore, js, rtol=1e-6)
    if case == "ties_across_tiles":
        assert pi == _numpy_select(*_inputs("random"))[0] % TILE   # the first copy wins


@pytest.mark.parametrize("n", [1, 777, N + 5])
def test_plain_select_any_row_count(n):
    """The port takes any n (the JAX kernel needs a multiple of its tile);
    checked against integer dots in numpy (index identical, rtol 1e-6)."""
    q, dirs, nrminv, bias = _inputs("row_scales", n=n, seed=3)
    ni, ns = _numpy_select(q, dirs, nrminv, bias)
    pi, pscore = _port(q, dirs, nrminv, bias)
    assert pi == ni
    np.testing.assert_allclose(pscore, ns, rtol=1e-6)


def test_pack_int4_round_trips_every_nibble(probe):
    """Every pair of nibbles -7..7 (and -8) packs as the probe packs and
    unpacks to itself."""
    vals = np.arange(-8, 8, dtype=np.int8)
    lo, hi = np.meshgrid(vals, vals, indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()], axis=1).reshape(-1, 2)       # (256, 2)
    q = np.tile(q, (1, 3))                                               # (256, 6)
    P = ps.pack_int4(torch.as_tensor(q))
    jq = jnp.asarray(q)
    jP = np.asarray(((jq[:, 0::2] & 0x0F) | (jq[:, 1::2] << 4)).astype(jnp.int8))
    np.testing.assert_array_equal(P.numpy(), jP)
    ulo, uhi = ps.unpack_int4(P)
    np.testing.assert_array_equal(ulo.numpy(), q[:, 0::2])
    np.testing.assert_array_equal(uhi.numpy(), q[:, 1::2])
    # the packed buffer carried over from numpy is the same tensor
    np.testing.assert_array_equal(interop.packed_buffer(jP).numpy(), P.numpy())


def test_kernel_dirs_layout():
    """The kernel's direction rows are [lo0, lo1, hi0, hi1], zero-padded."""
    dirs = np.random.default_rng(1).uniform(-1, 1, size=(10, 2)).astype(np.float32)
    q = np.clip(np.round(dirs * np.float32(127.0)), -127, 127).astype(np.int8)
    d4 = ps.kernel_dirs(torch.as_tensor(dirs), 16).numpy()
    assert d4.shape == (4, 16)
    np.testing.assert_array_equal(d4[:, :5], np.stack([q[0::2, 0], q[0::2, 1],
                                                       q[1::2, 0], q[1::2, 1]]))
    assert not d4[:, 5:].any()
    P = torch.zeros((3, 5), dtype=torch.int8)
    assert ps.padded(P).shape == (3, 16)


@pytest.mark.parametrize("bad", ["odd_S", "dirs_rows", "bias_shape", "dtype"])
def test_rejects_malformed_inputs(bad):
    q, dirs, nrminv, bias = _inputs("random", n=64)
    P = ps.pack_int4(torch.as_tensor(q))
    d, nr, b = torch.as_tensor(dirs), torch.as_tensor(nrminv), torch.as_tensor(bias)
    if bad == "odd_S":
        with pytest.raises(ValueError):
            ps.pack_int4(torch.zeros((4, 5), dtype=torch.int8))
        return
    if bad == "dirs_rows":
        d = d[:-2]
    elif bad == "bias_shape":
        b = b[:-1]
    else:
        P = P.to(torch.int16)
    with pytest.raises(ValueError):
        ps.packed_select(P, d, nr, b)


def test_wrapper_takes_rows_past_the_ring_kernels_width():
    """A packed row past 32 KB (the ring kernel's shared memory; the card
    takes its wide-row kernel there): no width limit in the wrapper, and on
    CPU tensors the plain version's result, checked against integer dots."""
    assert not hasattr(ps, "MAX_ROW_BYTES")
    S, n = 65568, 6
    rng = np.random.default_rng(9)
    q = rng.integers(-7, 8, size=(n, S)).astype(np.int8)
    dirs = rng.uniform(-0.04, 0.04, size=(S, 2)).astype(np.float32)
    nrminv = (0.02 * rng.uniform(0.5, 1.5, size=n)).astype(np.float32)
    bias = np.zeros(n, np.float32)
    P = ps.pack_int4(torch.as_tensor(q))
    assert P.shape == (n, 32784)
    ni, ns = _numpy_select(q, dirs, nrminv, bias)
    before = ps.launches
    pi, pscore = ps.packed_select(P, torch.as_tensor(dirs), torch.as_tensor(nrminv),
                                  torch.as_tensor(bias))
    assert ps.launches == before and int(pi) == ni
    np.testing.assert_allclose(float(pscore), ns, rtol=1e-6)
