"""The GIGA select of the PyTorch port against the JAX package.

The plain PyTorch select (the CPU route of ``giga_select``) is held against
the Pallas kernel ``giga_select_pallas`` run in interpret mode, as
tests/test_pallas.py runs it, and against the JAX package's default select
(``_select_dots`` + the score + ``_argmax_n``).  The index must match
exactly.  The score may differ by 1e-6 relative: for f32 and bf16 the
Pallas kernel multiplies by ``nrminv = 1/norms`` where the port divides by
``norms``.  The CUDA kernel itself is checked against the plain version
only on a card, in tests/test_torch_cuda.py (marker ``cuda``).

Besides the narrow rows (S=120) at every dtype, the select and the dots are
held at mid-width rows with a small n: f32 S=2048 (8 KB rows) and 12288
(48 KB), int8 S=16384 (16 KB), which the card streams through its wide-row
kernel.  The dots of ``giga_dots`` against ``_select_dots``: int8 dots equal
as integers (the JAX package's f32 ``dots * 1/127^2`` times 127^2, rounded,
recovers its int32 sums exactly below 2^22), f32 dots (divided by the
norms) within rtol 1e-5 and 1e-5 of the largest (sums of up to 12288
products in another order).
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
NP_MID, TILE_MID = 256, 128         # mid-width rows: rows, the Pallas kernel's tile
DTYPES = {"int8": (jnp.int8, torch.int8), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}
CASES = ["random", "invalid_tile", "all_invalid", "ties"]
# (dtype, columns): the narrow rows at every dtype, then the mid-width rows
MID_SHAPES = [("float32", 2048), ("float32", 12288), ("int8", 16384)]
SHAPES = ([pytest.param(sd, S, id=sd) for sd in DTYPES]
          + [pytest.param(sd, cols, id=f"{sd}-S{cols}") for sd, cols in MID_SHAPES])


def _unit(v):
    return v / np.linalg.norm(v)


def _inputs(case, sd, seed=0, cols=S):
    """(V f32 (NP, S), Vsel numpy (NP, SP), norms, valid, dirs (S, 2)); at
    mid-width columns (V (NP_MID, cols), Vsel (NP_MID, cols)) the cases'
    rows sit at the same fractions of n."""
    n, sp = (NP, SP) if cols == S else (NP_MID, cols)
    at = lambda i: i * n // NP          # noqa: E731  (row i of NP, at n rows)
    rng = np.random.default_rng(seed if cols == S else seed + cols)
    V = rng.normal(size=(n, cols)).astype(np.float32)
    valid = np.ones(n, bool)
    # directions as GIGA forms them: cdir_n orthogonal to xw_n, both unit
    xw = _unit(V[:40].sum(axis=0) + 0.1 * rng.normal(size=cols))
    bvec = _unit(V.sum(axis=0))
    cd = _unit(bvec - (bvec @ xw) * xw)
    dirs = np.stack([cd, xw], axis=1).astype(np.float32)
    if case == "invalid_tile":
        valid[at(1024):] = False
        # the best rows of the whole input sit in the invalid tile
        V[at(1500)] = 5.0 * cd
        V[at(1600)] = 3.0 * cd
    elif case == "all_invalid":
        valid[:] = False
    elif case == "ties":
        best = int(np.argmax(V @ cd / np.linalg.norm(V, axis=1)))
        V[[best // 2, best, n - 1]] = V[best]        # three copies of the best row
        V[at(1700):at(1710)] = V[best // 2]
    norms = np.linalg.norm(V, axis=1).astype(np.float32)
    if sd == "int8":
        Vsel = np.clip(np.round(V / norms[:, None] * 127.0), -127, 127).astype(np.int8)
    else:
        Vsel = V.astype(DTYPES[sd][0]) if sd == "bfloat16" else V
        Vsel = np.asarray(Vsel)
    Vsel = np.pad(Vsel, ((0, 0), (0, sp - cols)))
    return V, Vsel, norms, valid, dirs


def _port(Vsel, norms, valid, dirs, sd):
    if sd == "bfloat16":
        vt = torch.as_tensor(Vsel.view(np.int16)).view(torch.bfloat16)
    else:
        vt = torch.as_tensor(Vsel)
    i, s = gs.giga_select(vt, torch.as_tensor(dirs), torch.as_tensor(norms),
                          torch.as_tensor(valid))
    return int(i), float(s)


def _jax_consts(V, Vsel, norms, valid, sd):
    return jsn.SNNLSConsts(jnp.asarray(V), jnp.zeros(V.shape[1]), jnp.asarray(norms),
                           jnp.float32(1.0), jnp.asarray(valid), jnp.zeros(0),
                           jnp.asarray(Vsel) if sd != "float32" else jnp.asarray(V)[:0])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sd,cols", SHAPES)
def test_plain_select_matches_pallas_kernel(sd, cols, case):
    _, Vsel, norms, valid, dirs = _inputs(case, sd, cols=cols)
    nrminv = (np.ones(len(norms), np.float32) if sd == "int8"
              else (1.0 / norms).astype(np.float32))
    bias = np.where(valid, 0.0, -np.inf).astype(np.float32)
    tile = 1024 if cols == S else TILE_MID
    with pltpu.force_tpu_interpret_mode():
        ji, js = giga_select_pallas(jnp.asarray(Vsel), jnp.asarray(dirs),
                                    jnp.asarray(nrminv), jnp.asarray(bias), tile_rows=tile)
    ti, ts = _port(Vsel, norms, valid, dirs, sd)
    assert ti == int(ji)
    if case == "all_invalid":
        assert ti == 0 and ts == -np.inf
    else:
        np.testing.assert_allclose(ts, float(js), rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sd,cols", SHAPES)
def test_plain_select_matches_default_select(sd, cols, case):
    """The JAX package's default select: score matmul, guards, argmax."""
    V, Vsel, norms, valid, dirs = _inputs(case, sd, cols=cols)
    consts = _jax_consts(V, Vsel, norms, valid, sd)
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


@pytest.mark.parametrize("sd,cols", [p for p in SHAPES if p.values[0] != "bfloat16"])
def test_plain_dots_match_jax(sd, cols):
    """``giga_dots`` (the dots-only mode's plain version) against the JAX
    package's ``_select_dots`` on the same rows and directions."""
    V, Vsel, norms, valid, dirs = _inputs("random", sd, cols=cols)
    want = np.asarray(jsn._select_dots(_jax_consts(V, Vsel, norms, valid, sd),
                                       jnp.asarray(dirs)))
    got = gs.giga_dots(torch.as_tensor(Vsel), torch.as_tensor(dirs))
    if sd == "int8":
        assert got.dtype == torch.int32
        ints = np.rint(want.astype(np.float64) * 127.0 ** 2).astype(np.int64)
        assert np.abs(ints).max() < 2 ** 22
        np.testing.assert_array_equal(got.numpy().astype(np.int64), ints)
    else:
        assert got.dtype == torch.float32
        scaled = (got / torch.as_tensor(norms)[:, None]).numpy()
        np.testing.assert_allclose(scaled, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


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


@pytest.mark.parametrize("dtype,S", [(torch.float32, 12289), (torch.float32, 16384),
                                     (torch.bfloat16, 24584), (torch.int8, 49168)])
def test_wrapper_takes_rows_past_the_ring_kernels_width(dtype, S):
    """Rows past 48 KB (the ring kernel's shared memory; the card takes its
    wide-row kernel there): the wrapper has no width limit, and on CPU
    tensors gives the plain version's result, checked against f64 numpy."""
    assert not hasattr(gs, "MAX_ROW_BYTES")
    rng = np.random.default_rng(S)
    n = 12
    V = rng.normal(size=(n, S)).astype(np.float32)
    norms = np.linalg.norm(V, axis=1).astype(np.float32)
    dirs = np.zeros((S, 2), np.float32)
    dirs[:, 0] = V[7] / norms[7] + 0.01 * rng.normal(size=S) / np.sqrt(S)   # row 7 wins
    mult = gs.col_multiple(dtype)
    Sp = -(-S // mult) * mult
    Vp = torch.nn.functional.pad(torch.as_tensor(V), (0, Sp - S))
    if dtype == torch.int8:
        Vsel = torch.clamp(torch.round(Vp / torch.as_tensor(norms)[:, None] * 127.0),
                           -127, 127).to(torch.int8)
    else:
        Vsel = Vp.to(dtype)
    assert Vsel.shape[1] * Vsel.element_size() > 48 * 1024
    before = gs.launches
    f, score = gs.giga_select(Vsel, torch.as_tensor(dirs), torch.as_tensor(norms),
                              torch.ones(n, dtype=torch.bool))
    assert gs.launches == before and int(f) == 7
    if dtype == torch.int8:     # integer dots of the quantized copies, exact
        q = np.clip(np.round(dirs[:, 0] * np.float32(127.0)), -127, 127).astype(np.int64)
        want = (Vsel.numpy()[:, :S].astype(np.int64) @ q) / 127.0 ** 2
        rtol = 1e-6
    else:
        want = (V.astype(np.float64) @ dirs[:, 0].astype(np.float64)) / norms
        rtol = 1e-5 if dtype == torch.float32 else 2e-2
    assert int(np.argmax(want)) == 7
    np.testing.assert_allclose(float(score), want[7], rtol=rtol)


def _tensor(Vsel, sd):
    if sd == "bfloat16":
        return torch.as_tensor(Vsel.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(Vsel)


BLOCKS = [(0, 48), (48, 96), (96, SP)]     # a column split into whole 16-byte rows


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sd", list(DTYPES))
def test_split_dots_then_score_equal_the_fused_select(sd, case):
    """The proj axis's select: ``giga_dots_ref`` of each column block with
    its slice of the directions, summed, then ``giga_score_select_ref``,
    against the fused plain select on the unsplit matrix.  Unsplit, the two
    kernels' plain versions give the fused result bit for bit.  Split, int8
    dots are integers, so their sum and the result are exact; f32 and bf16
    sums are taken in another order: the same index, the score within 1e-6
    relative (where the best two scores are further apart than that)."""
    _, Vsel, norms, valid, dirs = _inputs(case, sd)
    vt, d = _tensor(Vsel, sd), torch.as_tensor(dirs)
    nt, ok = torch.as_tensor(norms), torch.as_tensor(valid)
    fi, fs = gs.giga_select_ref(vt, d, nt, ok)
    whole = gs.giga_dots_ref(vt, d)
    assert whole.shape == (NP, 2)
    assert whole.dtype == (torch.int32 if sd == "int8" else torch.float32)
    wi, ws = gs.giga_score_select_ref(whole, nt, ok)
    assert (int(wi), float(ws)) == (int(fi), float(fs))
    split = sum(gs.giga_dots_ref(vt[:, c0:c1].contiguous(), d[c0:min(c1, S)])
                for c0, c1 in BLOCKS)
    si, ss = gs.giga_score_select_ref(split, nt, ok)
    if sd == "int8":
        assert split.dtype == torch.int32
        torch.testing.assert_close(split, whole, rtol=0, atol=0)
        assert (int(si), float(ss)) == (int(fi), float(fs))
        return
    assert int(si) == int(fi)
    if case == "all_invalid":
        assert float(ss) == float(fs) == float("-inf") and int(si) == 0
    else:
        np.testing.assert_allclose(float(ss), float(fs), rtol=1e-6)


def test_dots_and_score_cpu_route_count_no_launch():
    """On CPU tensors the two wrappers run their plain versions; only a
    CUDA launch counts."""
    _, Vsel, norms, valid, dirs = _inputs("ties", "int8")
    vt, d = torch.as_tensor(Vsel), torch.as_tensor(dirs)
    before = (gs.dots_launches, gs.score_launches, gs.launches)
    dots = gs.giga_dots(vt, d)
    torch.testing.assert_close(dots, gs.giga_dots_ref(vt, d), rtol=0, atol=0)
    i, s = gs.giga_score_select(dots, torch.as_tensor(norms), torch.as_tensor(valid))
    assert (int(i), float(s)) == _port(Vsel, norms, valid, dirs, "int8")
    assert (gs.dots_launches, gs.score_launches, gs.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "norms", "valid", "empty"])
def test_score_wrapper_rejects_what_the_kernel_does_not_take(bad):
    n = 64
    args = dict(dots=torch.zeros((n, 2), dtype=torch.int32), norms=torch.ones(n),
                valid=torch.ones(n, dtype=torch.bool))
    if bad == "dtype":
        args["dots"] = args["dots"].double()
    elif bad == "shape":
        args["dots"] = torch.zeros((n, 3), dtype=torch.int32)
    elif bad == "norms":
        args["norms"] = torch.ones(n + 1)
    elif bad == "valid":
        args["valid"] = args["valid"].to(torch.uint8)
    else:
        args = dict(dots=torch.zeros((0, 2), dtype=torch.int32), norms=torch.ones(0),
                    valid=torch.ones(0, dtype=torch.bool))
    with pytest.raises(ValueError):
        gs.giga_score_select(**args)
