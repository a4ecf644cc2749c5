"""The GIGA select of the PyTorch port against the JAX package.

The plain PyTorch select (the CPU route of ``giga_select``) is held against
the Pallas kernel ``giga_select_pallas`` run in interpret mode, as
tests/test_pallas.py runs it, and against the JAX package's default select
(``_select_dots`` + the score + ``_argmax_n``).  The index must match
exactly.  The score may differ by 1e-6 relative: for f32 and bf16 the
Pallas kernel multiplies by ``nrminv = 1/norms`` where the port divides by
``norms``.  The CUDA kernel itself is checked against the plain version
only on a card, in tests/test_torch_cuda.py (marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesian_coresets_tpu.ops import snnls as jsn
from bayesian_coresets_tpu.ops.pallas_kernels import giga_select_pallas
from bayesian_coresets_tpu_torch.ops import giga_select as gs

torch.set_num_threads(1)

NP, SP, S = 2048, 128, 120          # JAX's tile asserts: np % 1024, Sp % 128
DTYPES = {"int8": (jnp.int8, torch.int8), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}
CASES = ["random", "invalid_tile", "all_invalid", "ties"]


def _unit(v):
    return v / np.linalg.norm(v)


def _inputs(case, sd, seed=0):
    """(V f32 (NP, S), Vsel numpy (NP, SP), norms, valid, dirs (S, 2))."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(NP, S)).astype(np.float32)
    valid = np.ones(NP, bool)
    # directions as GIGA forms them: cdir_n orthogonal to xw_n, both unit
    xw = _unit(V[:40].sum(axis=0) + 0.1 * rng.normal(size=S))
    bvec = _unit(V.sum(axis=0))
    cd = _unit(bvec - (bvec @ xw) * xw)
    dirs = np.stack([cd, xw], axis=1).astype(np.float32)
    if case == "invalid_tile":
        valid[1024:] = False
        # the best rows of the whole input sit in the invalid tile
        V[1500] = 5.0 * cd
        V[1600] = 3.0 * cd
    elif case == "all_invalid":
        valid[:] = False
    elif case == "ties":
        best = int(np.argmax(V @ cd / np.linalg.norm(V, axis=1)))
        V[[best // 2, best, NP - 1]] = V[best]       # three copies of the best row
        V[1700:1710] = V[best // 2]
    norms = np.linalg.norm(V, axis=1).astype(np.float32)
    if sd == "int8":
        Vsel = np.clip(np.round(V / norms[:, None] * 127.0), -127, 127).astype(np.int8)
    else:
        Vsel = V.astype(DTYPES[sd][0]) if sd == "bfloat16" else V
        Vsel = np.asarray(Vsel)
    Vsel = np.pad(Vsel, ((0, 0), (0, SP - S)))
    return V, Vsel, norms, valid, dirs


def _port(Vsel, norms, valid, dirs, sd):
    if sd == "bfloat16":
        vt = torch.as_tensor(Vsel.view(np.int16)).view(torch.bfloat16)
    else:
        vt = torch.as_tensor(Vsel)
    i, s = gs.giga_select(vt, torch.as_tensor(dirs), torch.as_tensor(norms),
                          torch.as_tensor(valid))
    return int(i), float(s)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sd", list(DTYPES))
def test_plain_select_matches_pallas_kernel(sd, case):
    _, Vsel, norms, valid, dirs = _inputs(case, sd)
    nrminv = np.ones(NP, np.float32) if sd == "int8" else (1.0 / norms).astype(np.float32)
    bias = np.where(valid, 0.0, -np.inf).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ji, js = giga_select_pallas(jnp.asarray(Vsel), jnp.asarray(dirs),
                                    jnp.asarray(nrminv), jnp.asarray(bias))
    ti, ts = _port(Vsel, norms, valid, dirs, sd)
    assert ti == int(ji)
    if case == "all_invalid":
        assert ti == 0 and ts == -np.inf
    else:
        np.testing.assert_allclose(ts, float(js), rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sd", list(DTYPES))
def test_plain_select_matches_default_select(sd, case):
    """The JAX package's default select: score matmul, guards, argmax."""
    V, Vsel, norms, valid, dirs = _inputs(case, sd)
    consts = jsn.SNNLSConsts(jnp.asarray(V), jnp.zeros(S), jnp.asarray(norms),
                             jnp.float32(1.0), jnp.asarray(valid), jnp.zeros(0),
                             jnp.asarray(Vsel) if sd != "float32" else jnp.asarray(V)[:0])
    dots = jsn._select_dots(consts, jnp.asarray(dirs))
    d1 = dots[:, 1]
    geo_ok = (d1 > -1.0 + 1e-14) & (1.0 - d1 * d1 > 0.0)
    denom = jnp.sqrt(jnp.clip(1.0 - d1 * d1, 1e-30, None))
    score = jnp.where(geo_ok, dots[:, 0] / denom, 0.0)
    score = jnp.where(consts.valid, score, -jnp.inf)
    ji, js = jsn._argmax_n(score)
    ti, ts = _port(Vsel, norms, valid, dirs, sd)
    assert ti == int(ji)
    if case == "all_invalid":
        assert ti == 0 and ts == -np.inf
    else:
        np.testing.assert_allclose(ts, float(js), rtol=1e-6)


def test_ties_pick_the_first_maximum():
    _, Vsel, norms, valid, dirs = _inputs("ties", "int8")
    ti, _ = _port(Vsel, norms, valid, dirs, "int8")
    dup = np.flatnonzero((Vsel == Vsel[ti]).all(axis=1))
    assert dup.size >= 3 and ti == dup[0]


def test_cpu_route_counts_no_launch():
    _, Vsel, norms, valid, dirs = _inputs("random", "int8")
    before = gs.launches
    _port(Vsel, norms, valid, dirs, "int8")
    assert gs.launches == before


@pytest.mark.parametrize("bad", ["cols", "dtype", "dirs", "valid", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, Vsel, norms, valid, dirs = _inputs("random", "int8")
    args = dict(Vsel=torch.as_tensor(Vsel), dirs=torch.as_tensor(dirs),
                norms=torch.as_tensor(norms), valid=torch.as_tensor(valid))
    if bad == "cols":
        args["Vsel"] = args["Vsel"][:, :S].contiguous()        # 120 bytes per row
        args["Vsel"] = torch.nn.functional.pad(args["Vsel"], (0, 1))
    elif bad == "dtype":
        args["Vsel"] = args["Vsel"].to(torch.int16)
    elif bad == "dirs":
        args["dirs"] = args["dirs"].double()
    elif bad == "valid":
        args["valid"] = args["valid"].to(torch.uint8)
    else:
        args["Vsel"] = args["Vsel"].to("meta")
        args.update({k: v.to("meta") for k, v in args.items()})
    with pytest.raises(ValueError):
        gs.giga_select(**args)
