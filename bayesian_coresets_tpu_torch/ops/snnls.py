"""Sparse non-negative least squares on one device: GIGA, Frank-Wolfe,
orthogonal matching pursuit, and importance and uniform sampling.

Port of ``bayesian_coresets_tpu/ops/snnls.py`` (reference
``bayesiancoresets/snnls/``: ``snnls.py``, ``giga.py``, ``frankwolfe.py``,
``orthopursuit.py``, ``sampling.py``).  The algebra is the JAX package's,
step for step:

- **Incremental O(S) reweighting.**  Every step has the form
  ``w <- alpha*w; w[f] = new``, so the cached image ``xw = A @ w`` updates
  as ``alpha*xw + delta*A[:, f]``; an exact refresh from the tracked
  support runs every ``REFRESH_EVERY`` iterations to bound f32 drift.
- **Scale-carried weights** (GIGA, Frank-Wolfe).  The global ``alpha``
  rescale rides a scalar (``GigaAux.wscale``): only index f is written per
  iteration, and the scale folds into the weights when it would underflow
  and once on return.
- **Flags, not exceptions.**  A failed step is discarded and counted; two
  consecutive failures, or selecting more distinct atoms than
  ``max_active``, latch ``done`` (reference snnls.py:40-74).
- **Data-point-major layout.**  ``V = A.T`` is (n, S); the select streams
  a reduced-precision copy ``Vsel`` once per iteration through the fused
  kernel of :mod:`.giga_select`: GIGA with its two directions, Frank-Wolfe
  and OMP with ``[rn, 0]`` (then the score is the plain normalized dot,
  the JAX package's ``_select_dots``).  The sampling solvers select by a
  categorical draw and never pass over V.
- **int8-resident constants** (:func:`make_consts_quantized`, the JAX
  package's beyond-f32-memory mode).  V itself is the int8 copy of
  normalized rows, with f32 norms beside it, and ``Vsel`` is V: no f32
  (n, S) exists.  Every read of V dequantizes the rows it reads
  (:func:`_rows`: ``V[f] * (norms[f] * (1/127))``), and
  the dense matvec gathers only the top ``support`` weights' rows
  (:func:`_v_matvec`).

The JAX package runs the whole build as one ``lax.while_loop``
(``build_core``).  Here the loop body is :func:`_segment`: ``n`` iterations
on device values alone, each gated by a device flag ``live = (itr <
itr_end) & ~done`` (JAX's ``cond``) that every write is ``where``-gated by,
so that a segment that outlives the build or latches ``done`` half-way
changes nothing more.  :func:`build` walks the segments of
:func:`segments` (the refresh begins a segment, at multiples of
``REFRESH_EVERY``) and reads back one pair (``done``, ``itr``) per segment.
On a CUDA device without ``comm`` each segment replays the CUDA graphs of
its :func:`pieces` (:mod:`.graphs`); on CPU tensors and in sharded builds
the segments are one iteration long and run directly.  On a CUDA device
without ``comm``, a GIGA build with support slots on float32 or
int8-resident V runs each iteration as four kernels, the select and the
fold between two of :mod:`.giga_step` (:func:`_fused`).  The weight vector
(the sampling solvers' counts) is updated in place, and on that fused route
the rest of the state too: ``build`` copies the state once on entry.

The O(S) and O(K*S) reductions of the step (the scalar cache, the reweight
dots, the support refresh) accumulate in float64 and round to float32, and
square roots are taken in float64 (``sqrt_rn``).  Their results then do not
depend on the order of a sum or on the device's square root, so a build
selects the same atoms on the CPU and on the GPU (the select itself is
exact for int8, and the kernel and its plain version round alike).  Nothing
on the path divides by a Python scalar: PyTorch's CUDA division by one
multiplies by its reciprocal, which the CPU does not.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..utils import checkpoint, config
from ..utils.errors import NumericalPrecisionError
from ..utils.profiling import span
from . import giga_step, graphs
from .fold_scale import fold_scale
from .giga_select import (col_multiple, giga_dots, giga_score_select, giga_select,
                          quantize_dirs, sqrt_rn)
from .nnls import nnls_rows

REFRESH_EVERY = 64      # exact xw = A@w recompute cadence (f32 drift control)
_WSCALE_FLOOR = giga_step.WSCALE_FLOOR
# iterations per replayed segment: REFRESH_EVERY, but OMP's iteration is
# ~6700 kernels (its 256 FISTA steps), so its graphs hold 4 (~27k nodes; a
# graph of 8 took 0.95 s to capture and instantiate on an H100, and chunked
# builds capture a head and a tail of their own)
_GRAPH_SEGMENT = {"orthopursuit": 4}

itrs_run = 0    # iterations build's segments ran (since last set to 0), gated ones included


class SNNLSConsts(NamedTuple):
    """Problem constants."""

    V: torch.Tensor       # (n, S) = A.T, rows are per-datum feature vectors;
    #                       int8 in the int8-resident mode (rows normalized and
    #                       scaled to ±127, see make_consts_quantized)
    b: torch.Tensor       # (S,) target vector
    norms: torch.Tensor   # (n,) row norms ||V[i]|| (1 for invalid rows)
    bnorm: torch.Tensor   # 0-dim ||b||
    valid: torch.Tensor   # (n,) bool mask of selectable rows
    ps: torch.Tensor      # (n,) sampling probabilities (importance, uniform;
    #                       size 0 for the other solvers)
    Vsel: torch.Tensor    # (n, Sp) select-phase copy of V, columns zero-padded
    #                       to whole 16-byte rows (the kernel's load width):
    #                       - float32: V itself (aliased when S needs no pad)
    #                       - bfloat16: half the bytes per select pass
    #                       - int8: a quarter; rows PRE-NORMALIZED and scaled
    #                         to ±127 (the /norms division folds into the
    #                         dequantization constant 1/127^2)
    #                       - int8-resident: V itself (the same tensor)


class SNNLSState(NamedTuple):
    """Solver state carried through the build loop."""

    w: torch.Tensor       # (n,) weights
    xw: torch.Tensor      # (S,) cached A @ w
    cts: torch.Tensor     # (n,) selection counts (sampling solvers; size 0 else)
    idcs: torch.Tensor    # (K,) int32 active-slot indices (-1 = empty)
    size: torch.Tensor    # int32 number of active slots
    itr: torch.Tensor     # int32 total iterations attempted (lifetime)
    fail: torch.Tensor    # int32 consecutive failed iterations
    done: torch.Tensor    # bool: numeric limit latched (snnls/snnls.py:66-69)


def _pad_cols(x: torch.Tensor, mult: int) -> torch.Tensor:
    S = x.shape[1]
    Sp = -(-S // mult) * mult
    return x if Sp == S else F.pad(x, (0, Sp - S))


def _sampling_ps(norms: torch.Tensor, valid: torch.Tensor, sampling: str | None,
                 comm=None) -> torch.Tensor:
    """Row-sampling probabilities of the importance and uniform solvers
    (ops/snnls.py:92-107 of the JAX package): proportional to the valid
    rows' norms (uniform over the valid rows when they sum to 0), or uniform
    over the valid rows.  The other solvers carry none (size 0), which
    :func:`init_state` reads as "no counts either".  With ``comm`` (this
    rank's rows of a row-sharded problem) the count and the sum are taken
    over every rank's rows."""
    if sampling is None:
        return torch.zeros(0, dtype=norms.dtype, device=norms.device)
    if sampling not in ("importance", "uniform"):
        raise ValueError(f"sampling must be None, 'importance' or 'uniform'; got {sampling!r}")
    raw = torch.where(valid, norms, 0.0)
    sums = torch.stack([torch.sum(valid).double(), torch.sum(raw.double())])
    if comm is not None:
        sums = comm.sum(sums, "setup")
    nv = torch.clamp_min(sums[0], 1).to(norms.dtype)
    uniform = torch.where(valid, torch.reciprocal(nv), 0.0)
    if sampling == "uniform":
        return uniform
    tot = sums[1].to(norms.dtype)
    return torch.where(tot > 0, raw / torch.where(tot > 0, tot, 1.0), uniform)


def make_consts(A: torch.Tensor, b: torch.Tensor, valid: torch.Tensor | None = None,
                select_dtype: torch.dtype | None = None,
                sampling: str | None = None, comm=None) -> SNNLSConsts:
    """Precompute solver constants from A (S, n) and b (S,), on A's device.

    ``select_dtype`` (``torch.bfloat16`` or ``torch.int8``) stores a
    reduced-precision copy of V used only by the select; all weight and
    error arithmetic stays f32.  ``sampling`` (``"importance"`` or
    ``"uniform"``) adds that solver's probabilities ``ps``.  With ``comm``,
    A holds this rank's columns of a row-sharded problem and b the global
    target (``parallel/coreset.py``).
    """
    V = A.T.contiguous()
    b = b.to(V.device)
    if valid is None:
        valid = torch.ones(V.shape[0], dtype=torch.bool, device=V.device)
    norms, valid, Vsel = row_consts(V, valid, select_dtype)
    bnorm = torch.sqrt(torch.sum(b * b))
    Vsel = _pad_cols(Vsel, col_multiple(Vsel.dtype))
    return SNNLSConsts(V, b, norms, bnorm, valid, _sampling_ps(norms, valid, sampling, comm),
                       Vsel)


def row_consts(V: torch.Tensor, valid: torch.Tensor, select_dtype=None):
    """(norms, valid, Vsel) of the rows V (n, S) as :func:`make_consts`
    makes them, Vsel not yet column-padded: the row norms (1 where a row is
    invalid, and a zero row is), and the selection copy (V itself, bf16, or
    int8 of the rows normalized and scaled to ±127)."""
    norms = torch.sqrt(torch.sum(V * V, dim=1))
    valid = valid.to(V.device) & (norms > 0)
    norms = torch.where(valid, norms, 1.0)
    if select_dtype is None or select_dtype == V.dtype:
        Vsel = V
    elif select_dtype == torch.int8:
        Vn = V / norms[:, None]
        Vsel = torch.clamp(torch.round(Vn * 127.0), -127, 127).to(torch.int8)
    elif select_dtype == torch.bfloat16:
        Vsel = V.to(torch.bfloat16)
    else:
        raise ValueError(f"select_dtype must be None, bfloat16 or int8; got {select_dtype}")
    return norms, valid, Vsel


def make_consts_quantized(Vq: torch.Tensor, norms: torch.Tensor, b: torch.Tensor,
                          valid: torch.Tensor | None = None,
                          sampling: str | None = None, comm=None) -> SNNLSConsts:
    """int8-resident constants (ops/snnls.py:159-198 of the JAX package),
    on ``Vq``'s device.

    ``Vq`` (n, S) int8: each row of V normalized to unit length and scaled
    to ±127 (:func:`..parallel.streamed.quantize_chunk`); ``norms`` (n,)
    the rows' norms; ``b`` the target, of at most ``Vq``'s column count.
    Only the int8 copy and the f32 norms are kept: no f32 (n, S) is formed.
    The select reads V itself (``Vsel`` is ``Vq``, as the JAX package's
    ``_vsel`` reads V behind its zero-row sentinel), and the weight and
    error arithmetic dequantizes the rows it reads.

    Rows: the JAX package pads them to a 1024 multiple for its Pallas tile;
    this package's kernel takes any row count, so none are added (padded
    rows that a caller brings, e.g. from the JAX package, stay: they must
    carry ``valid=False``).  With ``comm``, ``Vq`` and ``norms`` are this
    rank's rows of a row-sharded problem and ``b`` the global target.
    Columns: a ``Vq`` whose column count is a
    multiple of 16 (whole 16-byte rows for the kernel) is used as it is,
    never copied; otherwise it is zero-padded to one, which copies it (the
    streamed constructor allocates its buffer pre-padded).  ``b`` is
    zero-padded to the column count, which changes no inner product.  The
    norms are 1 on invalid rows, and a zero row is invalid.
    """
    if Vq.dtype != torch.int8 or Vq.dim() != 2:
        raise ValueError(f"make_consts_quantized takes a 2-D int8 matrix; got {Vq.dtype} "
                         f"{tuple(Vq.shape)}")
    dev = Vq.device
    Vq = _pad_cols(Vq.contiguous(), col_multiple(torch.int8))
    n, Sp = Vq.shape
    norms = norms.to(device=dev, dtype=torch.float32)
    b = b.to(device=dev, dtype=torch.float32)
    if b.shape[0] > Sp:
        raise ValueError(f"b has {b.shape[0]} entries for {Sp} columns")
    b = F.pad(b, (0, Sp - b.shape[0]))
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid = valid.to(dev) & (norms > 0)
    norms = torch.where(valid, norms, 1.0)
    # accumulated in f64: the card and the CPU give the same f32 norm
    bnorm = sqrt_rn(_dot(b, b))
    return SNNLSConsts(Vq, b, norms, bnorm, valid, _sampling_ps(norms, valid, sampling, comm),
                       Vq)


def _is_quantized(consts: SNNLSConsts) -> bool:
    return consts.V.dtype == torch.int8


def init_state(consts: SNNLSConsts, max_active: int = 0) -> SNNLSState:
    n, S = consts.V.shape
    # weights and caches stay f32 when V is the int8-resident copy
    dev = consts.V.device
    dt = consts.b.dtype if _is_quantized(consts) else consts.V.dtype
    i32 = dict(dtype=torch.int32, device=dev)
    return SNNLSState(
        w=torch.zeros(n, dtype=dt, device=dev),
        xw=torch.zeros(S, dtype=dt, device=dev),
        # counts exist only for the sampling solvers (ops/snnls.py:412 there)
        cts=torch.zeros(n if consts.ps.shape[0] else 0, dtype=dt, device=dev),
        idcs=torch.full((max_active,), -1, **i32),
        size=torch.zeros((), **i32),
        itr=torch.zeros((), **i32),
        fail=torch.zeros((), **i32),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _rows(consts: SNNLSConsts, idcs: torch.Tensor) -> torch.Tensor:
    """Rows V[idcs] (K, S) in f32, dequantized in the int8-resident mode as
    ``V[i] * (norms[i] * (1/127))`` (ops/snnls.py:250-270, 349-369 there)."""
    rows = consts.V.index_select(0, idcs)
    if _is_quantized(consts):
        rows = rows.float() * (consts.norms.index_select(0, idcs) * (1.0 / 127.0))[:, None]
    return rows


def _v_row(consts: SNNLSConsts, fl: torch.Tensor) -> torch.Tensor:
    """Row V[f] in f32; ``fl`` is the (1,) int64 index tensor."""
    return _rows(consts, fl)[0]


# ---------------------------------------------------------------------------
# Reads and writes by global index.  ``comm`` (``parallel/comm.py``) is None
# for one process.  Otherwise the constants and the (n,)-vectors are this
# rank's contiguous block of rows, every other value is replicated, and a
# read by global index is one owner-or-zero exchange (ops/snnls.py:205-370
# of the JAX package, there ``psum``s inside ``shard_map``).  The exchanged
# values are the owner's bit for bit, so every rank computes from them what
# one process computes.  Writes touch the owner's rows only.
#
# A build that also shards the projection dimension S (``comm.proj``, the
# proj axis's exchanges; ``build_sharded(shard_proj=True)``) holds a block
# of V's columns and the same block of b and xw: the rows that the reads
# above return are this block's slices of the rows (the JAX package's
# ``_v_row`` under proj sharding), sums over S are each rank's f64 partial
# summed over the proj axis (:func:`_sdot`, ``_psum_s`` there), and the
# select sums the rows' partial dots over it before scoring them
# (:func:`_select`).
# ---------------------------------------------------------------------------


def _proj(comm):
    """The proj axis's exchanges of a build that shards S, else None."""
    return None if comm is None else comm.proj


def _sdot(x: torch.Tensor, y: torch.Tensor, comm=None) -> torch.Tensor:
    """:func:`_dot` of operands whose last axis is S: under proj sharding
    each rank's f64 partial, summed over the proj axis in f64 (one
    exchange), then rounded to f32."""
    pc = _proj(comm)
    if pc is None:
        return _dot(x, y)
    p = x.double() @ y.double()
    flat = p.reshape(-1)
    pc.all_reduce(flat, "s_sum")
    return flat.reshape(p.shape).float()


def _sdots(pairs, comm=None) -> list:
    """``[_sdot(x, y) for x, y in pairs]`` of 1-D pairs, with one exchange
    under proj sharding."""
    pc = _proj(comm)
    if pc is None:
        return [_dot(x, y) for x, y in pairs]
    p = torch.stack([x.double() @ y.double() for x, y in pairs])
    return list(pc.all_reduce(p, "s_sum").float())


def _gather(consts: SNNLSConsts, idcs: torch.Tensor, comm, vecs=(), mask=None,
            kind: str = "row", dequantize: bool = True):
    """(Rows V[idcs] (K, S) in f32, [v[idcs] for v in vecs]), zero where
    ``~mask``; rows dequantized in the int8-resident mode unless
    ``dequantize=False``.  Sharded: one exchange of K x (S + len(vecs))
    values (the JAX package's ``_v_row``, ``_get1``, ``_gather_vec`` and
    ``_gather_rows`` in one)."""
    j, mine = (idcs, None) if comm is None else comm.local(idcs)
    rows = _rows(consts, j) if dequantize else consts.V.index_select(0, j).float()
    vals = [v.index_select(0, j) for v in vecs]
    if comm is not None:
        S = rows.shape[1]
        block = comm.owned(torch.cat([rows] + [v[:, None] for v in vals], dim=1), mine, kind)
        rows, vals = block[:, :S], [block[:, S + i] for i in range(len(vals))]
    if mask is not None:
        rows = torch.where(mask[:, None], rows, 0.0)
        vals = [torch.where(mask, v, 0.0) for v in vals]
    return rows, vals


def _set1(x: torch.Tensor, fl: torch.Tensor, val: torch.Tensor, comm) -> None:
    """x[f] = val in place (``fl`` the (1,) global index); sharded, only the
    owner writes."""
    if comm is None:
        x.index_copy_(0, fl, val.view(1))
        return
    j, mine = comm.local(fl)
    x.index_copy_(0, j, torch.where(mine, val.view(1), x.index_select(0, j)))


def _scatter(template: torch.Tensor, idcs: torch.Tensor, mask: torch.Tensor,
             vals: torch.Tensor, comm) -> torch.Tensor:
    """zeros_like(template) with ``vals`` added at ``idcs`` where ``mask``;
    sharded, each rank adds the entries it owns."""
    if comm is None:
        return torch.zeros_like(template).index_add_(0, idcs, torch.where(mask, vals, 0.0))
    j, mine = comm.local(idcs)
    return torch.zeros_like(template).index_add_(0, j, torch.where(mask & mine, vals, 0.0))


def _v_matvec(consts: SNNLSConsts, w: torch.Tensor, support: int = 1024,
              comm=None) -> torch.Tensor:
    """V^T @ w in f32 (ops/snnls.py:372-399 there).

    Dense for f32 constants.  In the int8-resident mode the rows of the
    ``support`` largest weights are gathered and dequantized, never an f32
    (n, S): w >= 0, so while nnz(w) <= support its nonzeros are among them,
    and the build loop keeps nnz(w) <= max_active (it refuses and latches a
    step that would track one more atom), so ``support=max_active`` is exact
    for the weights a build makes.  Sharded, for every dtype: each rank's
    ``support`` largest weights and their rows go through one exchange
    (world x support x (S + 1) values), and the product is taken in f64.
    """
    if comm is not None:
        vals, idx = torch.topk(w, min(int(support), w.shape[0]))
        block = comm.gather(torch.cat([vals[:, None], _rows(consts, idx)], dim=1), "rows")
        return _dot(block[:, 0], block[:, 1:])
    if not _is_quantized(consts):
        return consts.V.T @ w
    vals, idx = torch.topk(w, min(int(support), w.shape[0]))
    return _dot(vals, _rows(consts, idx))


def error(consts: SNNLSConsts, w: torch.Tensor, support: int = 1024,
          comm=None) -> torch.Tensor:
    """||A w - b||_2 (snnls/snnls.py:28-29); ``support`` bounds nnz(w) for
    int8-resident constants, and on each rank for sharded ones
    (:func:`_v_matvec`)."""
    return _cached_error(consts, _v_matvec(consts, w, support=support, comm=comm), comm)


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 result of a product accumulated in f64 (order-independent)."""
    return (x.double() @ y.double()).float()


def _cached_error(consts: SNNLSConsts, xw: torch.Tensor, comm=None) -> torch.Tensor:
    r = (xw - consts.b).double()
    return sqrt_rn(_sdot(r, r, comm))


def _track_support(state: SNNLSState, f: torch.Tensor):
    """Insert f into the active-slot list if new.

    Slots are capped at ``max_active``; selecting MORE distinct atoms than
    that is a capacity overflow, returned third so the build loop refuses
    the step and latches ``done`` — the tracked support, and therefore the
    refreshes, must never silently drop a live atom.
    """
    if state.idcs.shape[0] == 0:
        return state.idcs, state.size, torch.zeros((), dtype=torch.bool,
                                                   device=state.idcs.device)
    return giga_step.track(state.idcs, state.size, f)


def _active_mask(idcs: torch.Tensor, size) -> tuple[torch.Tensor, torch.Tensor]:
    """(live-slot mask, slot indices with 0 at dead slots) of a slot list."""
    mask = torch.arange(idcs.shape[0], device=idcs.device) < size
    return mask, torch.where(mask, idcs, 0).long()


def _support_matvec(consts: SNNLSConsts, w, idcs, size, comm=None) -> torch.Tensor:
    """Exact V^T w via the tracked support (w>0 entries all lie in idcs);
    sharded, the tracked rows and weights come in one (K, S + 1) exchange
    and the product runs on every rank as on one process."""
    mask, safe = _active_mask(idcs, size)
    rows, (wv,) = _gather(consts, safe, comm, (w,), mask=mask, kind="rows")
    return _dot(wv, rows)


class GigaAux(NamedTuple):
    """Scalar cache carried across GIGA iterations (0-dim f32 tensors).

    The reweight algebra (giga.py:40-64) and the monotonicity check reduce
    to scalar functions of (b.xw, |xw|^2, a few per-atom dots); the cache
    is recomputed exactly at every refresh.  True weights are
    ``wscale * state.w``.
    """

    bxw: torch.Tensor     # b . xw
    nw2: torch.Tensor     # xw . xw
    err: torch.Tensor     # ||xw - b||
    wscale: torch.Tensor  # true w = wscale * state.w


def _aux_from_xw(consts: SNNLSConsts, xw: torch.Tensor, wscale=1.0, comm=None) -> GigaAux:
    r = (xw - consts.b).double()
    bxw, nw2, err2 = _sdots([(consts.b, xw), (xw, xw), (r, r)], comm)
    if not isinstance(wscale, torch.Tensor):      # a fill: no host-to-device copy
        wscale = torch.full((), wscale, dtype=torch.float32, device=xw.device)
    return GigaAux(bxw, nw2, sqrt_rn(err2), wscale)


class GigaStep(NamedTuple):
    """One GIGA step's candidate, where-gated by ``commit`` except for the
    single weight write that :func:`_carried_commit` applies."""

    fl: torch.Tensor       # (1,) int64 selected index
    ws2: torch.Tensor      # alpha * wscale
    fold: torch.Tensor     # ws2 below the underflow floor
    new_wf: torch.Tensor   # new TRUE weight of f
    old_raw: torch.Tensor  # current raw weight of f
    xw2: torch.Tensor      # candidate xw (true scale)
    commit: torch.Tensor
    ok: torch.Tensor
    overflow: torch.Tensor
    idcs2: torch.Tensor
    size2: torch.Tensor
    aux: GigaAux           # cache after the step (wscale not yet updated)


def _select(consts: SNNLSConsts, dirs: torch.Tensor, comm):
    """(global index, score) of the fused select over the valid rows;
    sharded, each rank selects over its own rows and one exchange of the
    ranks' (score, index) pairs picks the first maximum.  Under proj
    sharding a rank holds a block of each row's columns and ``dirs`` that
    block of the (globally normalized) directions: the rows' partial dots
    (:func:`.giga_select.giga_dots`) are summed over the proj axis in one
    (n_loc, 2) exchange, exact for int8, and then scored
    (:func:`.giga_select.giga_score_select`)."""
    pc = _proj(comm)
    if pc is None:
        f, score = giga_select(consts.Vsel, dirs, consts.norms, consts.valid)
    else:
        dots = pc.all_reduce(giga_dots(consts.Vsel, dirs), "dots")
        f, score = giga_score_select(dots, consts.norms, consts.valid)
    return (f, score) if comm is None else comm.argmax(f, score)


def _giga_step(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux,
               tol: float, comm=None, live=None) -> GigaStep:
    """One GIGA step's candidate; ``live`` (a device flag, or None for
    true) gates its commit."""
    fr = _giga_frame(consts, state, aux)
    xwn, cdirn = fr[5:]
    # scores for every candidate and their argmax: one pass over Vsel
    dirs = torch.stack([cdirn, xwn], dim=1)            # (S, 2), unit columns
    f, _ = _select(consts, dirs, comm)
    return _giga_reweight(consts, state, aux, tol, fr, f, comm, live)


def _giga_frame(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux):
    """(bnorm, nw, bxwn, cdirnrm, bn, xwn, cdirn) of the state, as
    :func:`.giga_step.frame` and :func:`.giga_step.unit_directions` give
    them: the select's directions are ``[cdirn, xwn]``."""
    fr = giga_step.frame(consts.bnorm, aux.bxw, aux.nw2)
    return fr + giga_step.unit_directions(consts.b, state.xw, *fr)


def _giga_reweight(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux, tol: float, fr,
                   f: torch.Tensor, comm=None, live=None) -> GigaStep:
    """The GIGA step after its select of row ``f`` (0-dim), from the
    state's frame ``fr`` (:func:`_giga_frame`)."""
    bnorm, nw_safe, bxwn, cdirnrm, bn, xwn, _ = fr
    ok_sel = cdirnrm >= tol                            # giga.py:27-29
    fl = f.long().view(1)

    # reweight (giga.py:40-64): one row gather (with the row's norm and raw
    # weight) + one (2,S) matvec + scalars
    rows, (nfv, oldv) = _gather(consts, fl, comm, (consts.norms, state.w))
    xf, nf, old_raw = rows[0], nfv[0], oldv[0]
    xfn = xf / nf
    two = _sdot(torch.stack([bn, xwn]), xfn, comm)
    ws = aux.wscale
    ok_rw, alpha, new_wf, delta = giga_step.reweight(bnorm, nw_safe, bxwn, aux.bxw, aux.nw2, nf,
                                                     two[0], two[1], ws, old_raw)
    xw2 = alpha * state.xw + delta * xf                # xw stays TRUE-scale
    aux2 = _aux_from_xw(consts, xw2, wscale=aux.wscale, comm=comm)

    # monotonicity check (reference snnls.py:54-61).  Kept as the JAX
    # package has it: with support slots, size > 0 also counts atoms whose
    # weight later fell to 0 (ROADMAP Queue 3, defect (a), kept for parity)
    if state.idcs.shape[0]:
        size_nonzero = state.size > 0
    else:
        size_nonzero = torch.any(state.w > 0)
    monotone_ok = ~size_nonzero | (aux2.err <= aux.err * (1.0 + tol))
    ok = ok_sel & ok_rw & monotone_ok & torch.isfinite(aux2.err)
    idcs2, size2, overflow = _track_support(state, f)
    commit = _gate(ok & ~overflow, live)

    aux_out = GigaAux(bxw=torch.where(commit, aux2.bxw, aux.bxw),
                      nw2=torch.where(commit, aux2.nw2, aux.nw2),
                      err=torch.where(commit, aux2.err, aux.err),
                      wscale=ws)
    ws2 = alpha * ws
    return GigaStep(fl, ws2, ws2 < _WSCALE_FLOOR, new_wf, old_raw, xw2, commit,
                    ok, overflow, idcs2, size2, aux_out)


def _gate(flag: torch.Tensor, live) -> torch.Tensor:
    return flag if live is None else flag & live


def _carried_commit(state: SNNLSState, st: GigaStep, comm=None):
    """Commit a scale-carried rank-1 update: the global alpha rescale folds
    into wscale, and only index f of the weights is written — in place.
    Where the scale would underflow and the step commits (``fold &
    commit``, a device flag), the scale is first folded into every weight,
    the JAX package's ``lax.cond`` (ops/snnls.py:698 there), by
    :func:`.fold_scale.fold_scale`, a kernel that returns at once while the
    flag is clear; the written weight is then ``new_wf / 1.0``, itself."""
    w = state.w
    fold_scale(w, st.fold & st.commit, st.ws2)
    _set1(w, st.fl, torch.where(st.commit, _raw(st), st.old_raw), comm)
    return (w, *_gated_commit(state, st))


def _raw(st: GigaStep) -> torch.Tensor:
    """The raw weight that a committed step writes to ``w[f]``: ``new_wf``
    over the new scale, or itself where the scale folds."""
    return st.new_wf / torch.where(st.fold, 1.0, st.ws2)


def _gated_commit(state: SNNLSState, st: GigaStep):
    """(xw, idcs, size, aux) of :func:`_carried_commit`: the step's where
    it commits, the state's elsewhere."""
    ws_out = torch.where(st.commit, torch.where(st.fold, 1.0, st.ws2), st.aux.wscale)
    return (torch.where(st.commit, st.xw2, state.xw),
            torch.where(st.commit, st.idcs2, state.idcs),
            torch.where(st.commit, st.size2, state.size),
            st.aux._replace(wscale=ws_out))


def _advance(s: SNNLSState, fail: torch.Tensor, latch: torch.Tensor, live) -> SNNLSState:
    """The loop's bookkeeping of an iteration: ``fail``, ``done`` (where
    ``latch``) and ``itr`` moved where ``live``."""
    return s._replace(fail=torch.where(live, fail, s.fail), done=s.done | (live & latch),
                      itr=s.itr + live.to(s.itr.dtype))


def _normalize(x: torch.Tensor, comm=None) -> torch.Tensor:
    """x / ||x||; a zero vector divides by 1 (ops/snnls.py:446-449 there)."""
    n = sqrt_rn(_sdot(x, x, comm))
    return x / torch.where(n == 0, 1.0, n)


def _select_residual(consts: SNNLSConsts, rn: torch.Tensor, comm=None):
    """(index, value) of the largest <V_i/||V_i||, rn> over the valid rows:
    the fused select with directions ``[rn, 0]``.  The second dot is exactly
    0 for every dtype, so the select's score is the first dot itself, for
    int8 the JAX package's ``int32 * (1/127^2)`` to the bit."""
    return _select(consts, torch.stack([rn, torch.zeros_like(rn)], dim=1), comm)


def _fw_step(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux, tol: float,
             nsum: torch.Tensor, comm=None, live=None) -> GigaStep:
    """Frank-Wolfe step (ops/snnls.py:712-758 there; reference
    frankwolfe.py:5-40), scale-carried and self-committing like GIGA: the
    rescale w <- (1 - gamma) w rides ``aux.wscale`` and only the selected
    index is written.  ``nsum`` is the sum of the valid rows' norms;
    ``live`` gates the commit as in :func:`_giga_step`."""
    resid = consts.b - state.xw
    f, _ = _select_residual(consts, _normalize(resid, comm), comm)   # scale-invariant argmax
    fl = f.long().view(1)

    rows, (nfv, oldv) = _gather(consts, fl, comm, (consts.norms, state.w))
    xf, nf, old_raw = rows[0], nfv[0], oldv[0]
    # as in _giga_step: with support slots, size == 0 ignores that every
    # tracked weight may have fallen to 0 (ROADMAP Queue 3, defect (a), kept
    # for parity with ops/snnls.py:726-727 there)
    if state.idcs.shape[0]:
        size_zero = state.size == 0
    else:
        size_zero = ~torch.any(state.w > 0)

    # line search (frankwolfe.py:26-37)
    dvec = nsum / nf * xf - state.xw
    gammanum, gammadenom = _sdots([(dvec, resid), (dvec, dvec)], comm)
    ok = (gammanum >= 0.0) & (gammadenom > 0.0) & (gammanum <= gammadenom)
    gamma = gammanum / torch.where(gammadenom == 0, 1.0, gammadenom)
    alpha = torch.where(size_zero, 0.0, 1.0 - gamma)
    beta = torch.where(size_zero, nsum / nf, nsum / nf * gamma)
    ok = ok | size_zero                                  # first-point vertex init

    ws = aux.wscale
    old_wf = ws * old_raw
    new_wf = torch.clamp_min(alpha * old_wf + beta, 0.0)
    delta = new_wf - alpha * old_wf
    xw2 = alpha * state.xw + delta * xf

    # the monotone gate in the step (reference snnls.py:54-61), so that the
    # commit gates the single-index write; FW carries no scalar error cache
    r_new, r_old = (xw2 - consts.b).double(), (state.xw - consts.b).double()
    new_err, prev_err = (sqrt_rn(e) for e in _sdots([(r_new, r_new), (r_old, r_old)], comm))
    ok = ok & (size_zero | (new_err <= prev_err * (1.0 + tol)))
    ok = ok & torch.isfinite(new_err)
    idcs2, size2, overflow = _track_support(state, f)
    ws2 = alpha * ws
    return GigaStep(fl, ws2, ws2 < _WSCALE_FLOOR, new_wf, old_raw, xw2,
                    _gate(ok & ~overflow, live), ok, overflow, idcs2, size2, aux)


def _select_dots_rows(rows: torch.Tensor, norms: torch.Tensor, rn: torch.Tensor) -> torch.Tensor:
    """<V_i/||V_i||, rn> for the given rows of the selection copy, computed
    as the select computes it for that dtype (int8: integer dots times
    1/127^2; else f32 dots over the row's norm)."""
    dirs = torch.stack([rn, torch.zeros_like(rn)], dim=1)
    q = quantize_dirs(dirs, rows.shape[1], rows.dtype)[0]
    if rows.dtype == torch.int8:
        return (rows.double() @ q.double()).float() * (1.0 / (127.0 * 127.0))
    return (rows.float() @ q.float()) / norms


def _gather_sel(consts: SNNLSConsts, w: torch.Tensor, idcs: torch.Tensor, comm):
    """Rows of the selection copy, norms and weights at ``idcs`` (OMP's
    negative side); sharded, one (K, Sp + 2) exchange (the int8 and bf16
    rows are exact in f32)."""
    j, mine = (idcs, None) if comm is None else comm.local(idcs)
    sel = consts.Vsel.index_select(0, j)
    norms, wv = consts.norms.index_select(0, j), w.index_select(0, j)
    if comm is None:
        return sel, norms, wv
    Sp = sel.shape[1]
    block = comm.owned(torch.cat([sel.float(), norms[:, None], wv[:, None]], dim=1), mine,
                       "rows")
    return block[:, :Sp].to(sel.dtype), block[:, Sp], block[:, Sp + 1]


def _omp_step(consts: SNNLSConsts, state: SNNLSState, nnls_iters: int = 256, comm=None):
    """Orthogonal matching pursuit step (ops/snnls.py:765-793 there;
    reference orthopursuit.py:7-42): the candidate ``(w, xw, idcs, size,
    overflow)``, which the loop gates and commits.

    Two argmaxes over one set of dots: the largest dot over the valid rows,
    and the largest NEGATED dot over the active rows (w > 0); the negative
    side wins only when some weight is positive and its value is strictly
    larger.  The positive side is the fused select.  The active rows all
    lie in the tracked support, so the negative side reads at most
    ``max_active`` gathered rows of the selection copy, never all of V;
    among equal values it takes the lowest row index, as an argmax over all
    rows in index order does.  Without support slots the full vector of dots
    is formed with torch ops.  Sharded: three exchanges (the select's, the
    active rows of the selection copy, and the NNLS system's rows), none
    of them over n."""
    n = consts.V.shape[0] if comm is None else comm.world * comm.n_loc
    rn = _normalize(consts.b - state.xw)    # scale-invariant: only comparisons matter
    fpos, vpos = _select_residual(consts, rn, comm)
    K = state.idcs.shape[0]
    if K:
        mask, safe = _active_mask(state.idcs, state.size)
        sel, norms_a, w_a = _gather_sel(consts, state.w, safe, comm)
        active = mask & (w_a > 0)
        dots = _select_dots_rows(sel, norms_a, rn)
        rows = safe
    else:
        active = state.w > 0
        dots = _select_dots_rows(consts.Vsel, consts.norms, rn)
        rows = torch.arange(n, device=dots.device)
    neg = torch.where(active, -dots, float("-inf"))
    vneg = torch.max(neg)
    fneg = torch.min(torch.where(active & (neg == vneg), rows, n))
    any_active = torch.any(active)
    f = torch.where(~any_active | (vpos >= vneg), fpos, fneg.to(fpos.dtype))

    idcs, size, overflow = _track_support(state, f)
    if K == 0:
        # no slots: the gathered system is empty and the weights stay 0,
        # as in the JAX package
        return torch.zeros_like(state.w), torch.zeros_like(state.xw), idcs, size, overflow
    # NNLS on the active slots (orthopursuit.py:37-41), warm-started from
    # the current weights
    mask0, safe0 = _active_mask(idcs, size)
    Aact, (x0,) = _gather(consts, safe0, comm, (state.w,), mask=mask0, kind="rows")
    w_act = nnls_rows(Aact, consts.b, mask0, num_iters=nnls_iters, x0=x0)
    w = _scatter(state.w, safe0, mask0, w_act, comm)
    return w, w_act @ Aact, idcs, size, overflow      # exact: support == active slots


class Draws:
    """The sampling solvers' random draws, one index per iteration, from a
    ``torch.Generator``.  Any object with the same method serves: the tests
    give ``build`` a source that replays the indices ``jax.random`` drew."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def index(self, cdf: torch.Tensor) -> torch.Tensor:
        """(1,) int64 index drawn with probability ``cdf[i] - cdf[i-1]``, by
        the inverse of the (unnormalized, f64) ``cdf``; nothing is read back
        to the host.  u lies in (0, cdf[-1]], so the first i with
        cdf[i] >= u exists and has positive probability."""
        r = torch.rand(1, generator=self.gen, dtype=cdf.dtype, device=self.gen.device)
        return torch.searchsorted(cdf, (1.0 - r.to(cdf.device)) * cdf[-1])


def as_draws(source) -> Draws:
    """A ``torch.Generator`` becomes a :class:`Draws`; a draw source is kept."""
    return Draws(source) if isinstance(source, torch.Generator) else source


def _sampling_weights(consts: SNNLSConsts, cts: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """w_i = (cts_i / T) / ps_i where ps_i > 0 (sampling.py:6-37)."""
    pos = consts.ps > 0
    return torch.where(pos, (cts / T) / torch.where(pos, consts.ps, 1.0), 0.0)


def _draw(consts: SNNLSConsts, draws, cdf: torch.Tensor, comm=None, shard_cdf=None):
    """One categorical draw: ((1,) int64 global index f, V[f] in f32,
    ps[f]).  ``cdf`` is the cumulative f64 sum of this rank's ``ps``.

    Sharded (ops/snnls.py:817-831 there), the draw is hierarchical: one
    uniform picks the shard by the ranks' masses (``shard_cdf``, their
    cumulative sum), a second the row within it by that shard's ``cdf``.
    Every rank draws both (the generators step in lockstep); the owner's
    row, probability and index come back in one f64 exchange.  Exact in
    distribution, and another realization than one process's draw."""
    if comm is None:
        fl = draws.index(cdf)
        rows, (psf,) = _gather(consts, fl, None, (consts.ps,))
        return fl, rows[0], psf[0]
    k = draws.index(shard_cdf)
    j = draws.index(cdf)
    block = torch.cat([_rows(consts, j)[0].double(), consts.ps.index_select(0, j).double(),
                       (j + comm.lo).double()])
    block = comm.owned(block[None], k == comm.rank, "draw")[0]
    S = block.shape[0] - 2
    return block[S + 1].long().view(1), block[:S].float(), block[S].float()


def _sampling_step(consts: SNNLSConsts, state: SNNLSState, fl: torch.Tensor,
                   xf: torch.Tensor, psf: torch.Tensor, T_old: torch.Tensor, comm=None,
                   live=None):
    """One categorical draw ``fl`` with its row ``xf`` and probability
    ``psf`` (ops/snnls.py:800-847 there): the count of f rises by one, in
    place (on its owner), and the cached image follows the weight map
    w_i = (cts_i / T) / ps_i in O(S): ``xw <- (T/(T+1)) xw + V[f] / ((T+1)
    ps_f)``.  A draw that would overflow the support slots changes nothing.
    Returns ``(xw, idcs, size, overflow)``; the weights are formed from the
    counts when they are needed (:func:`_sampling_weights`).  ``live``
    gates the commit as in :func:`_giga_step`."""
    idcs, size, overflow = _track_support(state, fl[0].to(torch.int32))
    commit = _gate(~overflow, live)
    if comm is None:
        state.cts.index_add_(0, fl, commit.to(state.cts.dtype).view(1))
    else:
        j, mine = comm.local(fl)
        state.cts.index_add_(0, j, (commit & mine).to(state.cts.dtype))
    T_new = T_old + 1.0
    alpha = T_old / T_new
    beta = 1.0 / (T_new * torch.clamp_min(psf, 1e-30))
    xw = alpha * state.xw + beta * xf
    return (torch.where(commit, xw, state.xw), torch.where(commit, idcs, state.idcs),
            torch.where(commit, size, state.size), overflow)


METHODS = ("giga", "frankwolfe", "orthopursuit", "importance", "uniform")
_SAMPLING = ("importance", "uniform")
_FRESH_SEED = torch.Generator().initial_seed()   # a new generator's seed
_default_gens: dict[torch.device, torch.Generator] = {}


class _Carry(NamedTuple):
    """What a build carries from one iteration to the next, all device
    values: the solver state, the GIGA/FW scalar cache, and the sampling
    solvers' first commit flag and last overflow; ``itr_end``, ``itr0``
    (the build's first iteration) and ``T0`` (the counts' sum on entry) are
    read and never written."""

    w: torch.Tensor
    xw: torch.Tensor
    cts: torch.Tensor
    idcs: torch.Tensor
    size: torch.Tensor
    itr: torch.Tensor
    fail: torch.Tensor
    done: torch.Tensor
    bxw: torch.Tensor
    nw2: torch.Tensor
    err: torch.Tensor
    wscale: torch.Tensor
    first_ok: torch.Tensor
    last_over: torch.Tensor
    itr_end: torch.Tensor
    itr0: torch.Tensor
    T0: torch.Tensor

    def state(self) -> SNNLSState:
        return SNNLSState(*self[:8])

    def aux(self) -> GigaAux:
        return GigaAux(*self[8:12])

    def update(self, s: SNNLSState, aux: GigaAux, **kw) -> "_Carry":
        return self._replace(**s._asdict(), **aux._asdict(), **kw)


class _Problem(NamedTuple):
    """What a build's iterations read and never write."""

    consts: SNNLSConsts
    method: str
    tol: float
    matvec_k: int
    comm: object
    draws: object                   # the sampling solvers' draw source
    cdf: torch.Tensor | None        # cumulative f64 ps (sampling)
    shard_cdf: torch.Tensor | None  # the ranks' cumulative masses (sharded sampling)
    nsum: torch.Tensor | None       # the valid rows' norms summed (Frank-Wolfe)


def _derived(consts: SNNLSConsts, method: str, comm=None):
    """(nsum, cdf): what the iterations read that depends on the constants
    alone (Frank-Wolfe's norm sum, the sampling solvers' f64 cdf)."""
    nsum = cdf = None
    if method == "frankwolfe":
        nsum = torch.sum(torch.where(consts.valid, consts.norms, 0.0).double())
        nsum = (nsum if comm is None else comm.sum(nsum, "setup")).float()
    if method in _SAMPLING:
        cdf = torch.cumsum(consts.ps.double(), dim=0)
    return nsum, cdf


def segments(start: int, count: int, length: int = REFRESH_EVERY):
    """The segments of a build of ``count`` iterations from iteration
    ``start``, in order, made as they are walked: ``(first iteration,
    iterations, begins with the refresh)``.  None is longer than ``length``
    (1 to REFRESH_EVERY) or crosses a multiple of ``length`` or of
    REFRESH_EVERY, so the refresh, at the multiples of REFRESH_EVERY,
    always begins one.  With ``length = REFRESH_EVERY``: a head up to the
    next refresh, whole segments, and a tail."""
    if not 1 <= length <= REFRESH_EVERY:
        raise ValueError(f"segment length must be in [1, {REFRESH_EVERY}]; got {length}")
    pos, end = int(start), int(start) + max(int(count), 0)
    while pos < end:
        n = min(length - pos % length, REFRESH_EVERY - pos % REFRESH_EVERY, end - pos)
        yield pos, n, pos % REFRESH_EVERY == 0
        pos += n


def pieces(n: int, refresh: bool) -> list[tuple[int, bool]]:
    """The pieces that a replayed segment of ``n`` iterations runs as, in
    order: ``(iterations, begins with the refresh)``, the iterations powers
    of two, largest first, and only the first beginning with the refresh
    where the segment does.  So every segment of :func:`segments` is made
    of at most 2 (log2(length) + 1) graphs: 14 at REFRESH_EVERY, whatever
    the build's length and start."""
    lengths = [1 << k for k in reversed(range(n.bit_length())) if n >> k & 1]
    return [(m, refresh and i == 0) for i, m in enumerate(lengths)]


def _segment(p: _Problem, c: _Carry, n: int, refresh: bool) -> _Carry:
    """``n`` iterations of ``p.method`` from ``c`` on device values alone,
    nothing read back to the host: the JAX package's ``build_core`` body
    (ops/snnls.py:909-981 there).  The first begins with the exact refresh
    where ``refresh`` says the segment starts at a multiple of
    REFRESH_EVERY."""
    step = None
    for i in range(n):
        c, step = _iteration(p, c, refresh and i == 0, step)
    return c


def _fused(p: _Problem, K: int) -> bool:
    """Whether GIGA's iterations take the fused route (:mod:`.giga_step`:
    four launches an iteration): on a CUDA device, unsharded, with support
    slots, on float32 or int8-resident V.  Every other build keeps
    :func:`_giga_step`'s ops, which the fused kernels compute bit for bit
    but for the order of their float64 sums."""
    V = p.consts.V
    return (p.method == "giga" and V.device.type == "cuda" and p.comm is None and K > 0
            and V.dtype in (torch.float32, torch.int8))


def _iteration(p: _Problem, c: _Carry, refresh: bool, step=None):
    """One iteration, gated by ``live = (itr < itr_end) & ~done`` (``cond``
    there, :905-907): every write is where-gated by it, ``itr`` included,
    so that an iteration past the build's end or after ``done`` latched
    changes nothing (a sampling solver's generator still draws).  Returns
    ``(carry, step)``: on the fused route (:func:`_fused`) ``step`` is the
    :class:`.giga_step.Step` that holds the next iteration's directions, for
    the next call of the segment (the first makes it from ``step=None``);
    elsewhere None."""
    consts, comm, method = p.consts, p.comm, p.method
    s, aux = c.state(), c.aux()
    K = s.idcs.shape[0]
    if method in _SAMPLING:
        T = c.T0 + (c.itr - c.itr0).to(c.T0.dtype)        # the draws counted so far
    if refresh:
        if method in _SAMPLING:
            s = s._replace(w=torch.where(c.itr > c.itr0,
                                         _sampling_weights(consts, s.cts, T), s.w))
        # exact refresh of the cached matvec AND the scalar cache; with
        # support slots it gathers only the tracked rows (O(K*S))
        exact = (_support_matvec(consts, s.w, s.idcs, s.size, comm) if K
                 else _v_matvec(consts, s.w, support=p.matvec_k))
        xw = aux.wscale * exact       # state.w is raw-scale (wscale is 1
        #                               for OMP and the sampling solvers)
        aux = _aux_from_xw(consts, xw, wscale=aux.wscale, comm=comm)
        s = s._replace(xw=xw)
    if _fused(p, K):
        # the step, the commit and the gating in place, in two kernels
        # around the select and the fold: see :mod:`.giga_step`
        c = c.update(s, aux)
        if step is None or refresh:         # a refresh made new xw and cache tensors
            step = giga_step.Step(consts, c, p.tol)
        step.iterate()
        return c, step
    live = (c.itr < c.itr_end) & ~c.done
    extra = {}
    if method in ("giga", "frankwolfe"):
        st = (_giga_step(consts, s, aux, p.tol, comm, live) if method == "giga"
              else _fw_step(consts, s, aux, p.tol, p.nsum, comm, live))
        fail = torch.where(st.ok, 0, s.fail + 1)
        # retry-once-then-latch; a support-capacity overflow latches at once
        latch = (fail >= 2) | st.overflow
        w, xw, idcs, size, aux = _carried_commit(s, st, comm)
        s = s._replace(w=w, xw=xw, idcs=idcs, size=size)
    elif method in _SAMPLING:
        xw, idcs, size, overflow = _sampling_step(
            consts, s, *_draw(consts, p.draws, p.cdf, comm, p.shard_cdf), T, comm, live)
        # every draw is ok: only an overflow, which needs slots, latches
        fail, latch = torch.zeros_like(s.fail), overflow
        extra = dict(first_ok=torch.where(live & (c.itr == c.itr0), ~overflow, c.first_ok),
                     last_over=torch.where(live, overflow, c.last_over))
        s = s._replace(xw=xw, idcs=idcs, size=size)
    else:
        w2, xw2, idcs2, size2, overflow = _omp_step(consts, s, comm=comm)
        # the loop's monotone gate (ops/snnls.py:946-954 there): fail iff
        # the error rose beyond the tolerance's slack
        size_nonzero = s.size > 0 if K else torch.any(s.w > 0)
        new_err = _cached_error(consts, xw2)
        ok = ((~size_nonzero | (new_err <= _cached_error(consts, s.xw) * (1.0 + p.tol)))
              & torch.isfinite(new_err))
        fail = torch.where(ok, 0, s.fail + 1)
        latch = (fail >= 2) | overflow
        commit = ok & ~overflow & live
        s = s._replace(w=torch.where(commit, w2, s.w), xw=torch.where(commit, xw2, s.xw),
                       idcs=torch.where(commit, idcs2, s.idcs),
                       size=torch.where(commit, size2, s.size))
    return c.update(_advance(s, fail, latch, live), aux, **extra), None


def _carry(consts: SNNLSConsts, state: SNNLSState, itr_end: int, comm=None) -> _Carry:
    """The carry of a build from ``state`` up to iteration ``itr_end``."""
    dev = state.w.device
    no = torch.zeros((), dtype=torch.bool, device=dev)
    return _Carry(*state, *_aux_from_xw(consts, state.xw, comm=comm), first_ok=no,
                  last_over=no, itr_end=torch.full((), itr_end, dtype=state.itr.dtype, device=dev),
                  itr0=state.itr, T0=torch.sum(state.cts))


def _read(c: _Carry, itr: int, latches: bool) -> tuple[int, bool]:
    """The host's one read of a segment, (itr, done); none where nothing
    can latch (a sampling build without slots), whose ``itr`` is known."""
    if not latches:
        return itr, False
    with span("snnls.read", device=c.itr.device):
        itr, done = torch.stack([c.itr, c.done.to(c.itr.dtype)]).tolist()
    return itr, bool(done)


def _graph_generator(draws, dev: torch.device) -> torch.Generator:
    """The generator a replayed sampling build draws from: ``draws`` itself
    or its :class:`Draws`' generator, or for ``None`` this device's own,
    seeded as a new generator is (so that replays of one graph serve every
    such build)."""
    if draws is None:
        gen = _default_gens.get(dev)
        if gen is None:
            gen = _default_gens.setdefault(dev, torch.Generator(device=dev))
        return gen.manual_seed(_FRESH_SEED)
    gen = draws if isinstance(draws, torch.Generator) else getattr(draws, "gen", None)
    if type(draws) not in (torch.Generator, Draws) or not isinstance(gen, torch.Generator):
        raise ValueError("a build on a CUDA device replays CUDA graphs, which draw from a "
                         f"torch.Generator; got the draw source {type(draws).__name__} "
                         "(pass segment=1 to run it one iteration at a time)")
    if config.resolve_device(gen.device) != dev:
        raise ValueError(f"the generator is on {gen.device}, the constants on {dev}")
    return gen


def _shares_graphs(consts: SNNLSConsts) -> bool:
    """Whether replayed builds and re-solves of ``consts`` run in graph sets
    shared by every constants of their layout, on static copies of the
    constants (:func:`.graphs.graphs_for`).  int8-resident constants keep
    sets of their own: a copy of their int8 matrix would halve the rows
    that the mode exists to hold.  So do constants with a tensor that is
    not contiguous, which no static copy could be guaranteed to match."""
    return not _is_quantized(consts) and all(t.is_contiguous() for t in consts)


def _build_key(method: str, tol: float, matvec_k: int, carry: _Carry) -> tuple:
    """What a replayed build's graphs depend on besides the constants."""
    return ("build", method, float(tol), int(matvec_k),
            tuple((t.dtype, tuple(t.shape)) for t in carry))


def _graph_set(consts: SNNLSConsts, key, gen, make_static, make_derived=lambda c: None):
    """(the :class:`.graphs.Graphs` under ``key`` for ``consts``, the
    constants its graphs read: static copies that ``consts`` were copied
    into, or ``consts`` themselves for a set of their own)."""
    e = graphs.graphs_for(tuple(consts), key, gen, make_static,
                          lambda c: make_derived(SNNLSConsts(*c)), shared=_shares_graphs(consts))
    return e, consts if e.consts is None else SNNLSConsts(*e.consts)


def _replaying(dev: torch.device, comm, segment: int | None) -> bool:
    """Whether ``build`` replays CUDA graphs: on a CUDA device, unsharded,
    unless the segments are one iteration long."""
    return dev.type == "cuda" and comm is None and segment != 1


def _replayer(consts: SNNLSConsts, carry: _Carry, method: str, tol: float, draws,
              matvec_k: int):
    """(a step ``(c, n, refresh) -> c`` that replays an ``n``-iteration
    segment as the CUDA graphs of its :func:`pieces`, each captured at first
    use, one per (iterations, refresh), in the graph set of ``consts``'
    layout (:func:`_graph_set`), on its static buffers with ``carry`` copied
    in: the state lives there until it is copied out; those buffers; the
    context inside which the steps draw what ``draws`` would,
    :func:`.graphs.draw_from`)."""
    gen = _graph_generator(draws, consts.V.device) if method in _SAMPLING else None
    e, sc = _graph_set(consts, _build_key(method, tol, matvec_k, carry), gen,
                       lambda: _Carry(*(torch.empty_like(t) for t in carry)),
                       lambda c: _derived(c, method))
    graphs.copy_into(e.static, carry)
    nsum, cdf = e.derived
    p = _Problem(sc, method, tol, matvec_k, None, None if gen is None else Draws(e.gen),
                 cdf, None, nsum)

    def step(c, n, refresh):
        for m, r in pieces(n, refresh):
            e.run((m, r), lambda m=m, r=r: graphs.copy_into(c, _segment(p, c, m, r)))
        return c

    return step, e.static, graphs.draw_from(e, gen)


def build(consts: SNNLSConsts, state: SNNLSState, itrs: int, tol: float,
          method: str = "giga", draws=None, matvec_k: int = 1024, comm=None,
          segment: int | None = None) -> SNNLSState:
    """Run up to ``itrs`` iterations of ``method``, continuing from ``state``.

    Port of the JAX package's ``build_core``/``build``
    (ops/snnls.py:870-989 there) for the five solvers: the iterations go in
    the segments of :func:`segments`, each run by :func:`_segment` on
    device values alone, and the host reads one pair (``itr``, ``done``)
    after each segment (none in a sampling build without slots, which
    cannot latch).  ``segment`` is the segments' length.  By default, on a
    CUDA device without ``comm``, segments of 64 iterations (OMP: 4) are
    replayed, each as the CUDA graphs of its :func:`pieces` (power-of-two
    lengths, so a set holds at most 14 graphs, OMP's 6, whatever the
    build's length and start), of one set per layout of the constants,
    which every constants of that layout and every generator share, and
    which outlives them (:mod:`.graphs`; int8-resident constants keep sets
    of their own: :func:`_shares_graphs`); on CPU tensors, in sharded
    builds and with ``segment=1`` they are one iteration long and run
    directly; on CPU tensors any length runs directly.  Every length gives
    the same weights, atoms, ``itr`` and ``done`` bit for bit; when ``done``
    latches inside a segment, its remaining iterations still run, gated,
    so the select kernel launches once per iteration run (counted in
    ``itrs_run``) and a sampling build's generator (but not the state) has
    advanced further than a one-iteration run leaves it.

    GIGA and Frank-Wolfe commit inside their step (the monotone gate
    included); OMP's candidate passes the loop's monotone gate and
    where-gated commit; the sampling solvers have no gate.  Two failed steps
    in a row, or a step that would track more than ``max_active`` atoms,
    latch ``done``.  ``draws`` (a ``torch.Generator`` on the data's device,
    or a draw source, see :class:`Draws`, which needs one-iteration
    segments on a CUDA device) feeds the sampling solvers; the default is a
    generator seeded as a new one is.  ``matvec_k`` bounds nnz(w) for the
    refresh without support slots on int8-resident constants
    (:func:`_v_matvec`; ignored for f32 V).  Returns a new state with
    TRUE-scale weights; ``state`` itself is left unchanged.

    ``comm`` (``parallel/comm.py``) runs this rank's part of a row-sharded
    build: ``consts``, ``state.w`` and ``state.cts`` hold this rank's rows,
    everything else is replicated, and the steps read rows by global index
    through the exchanges of ``comm`` (GIGA and Frank-Wolfe: two per
    iteration, the select's argmax and the selected row's, neither over n;
    OMP three; a draw one; a refresh one of the tracked rows).  Every rank
    then computes what one process computes, so the weights are the
    single-process build's bit for bit (the sampling solvers' in
    distribution, :func:`_draw`) and ``done`` agrees on every rank without
    another exchange.  A sharded build tracks its support: ``state`` needs
    slots (``max_active`` > 0), which the refresh gathers.
    """
    global itrs_run
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}; got {method!r}")
    if method == "orthopursuit" and _proj(comm) is not None:
        raise ValueError("orthopursuit's active-set NNLS needs full-S rows; shard the data "
                         "axis only (shard_proj=False)")
    if comm is not None and state.idcs.shape[0] == 0:
        raise ValueError("a sharded build tracks its support: make the state with "
                         "max_active > 0")
    sampling = method in _SAMPLING
    if sampling and state.cts.shape[0] != consts.V.shape[0]:
        raise ValueError(f"method {method!r} needs constants made with sampling= and a "
                         "state made from them (ps and cts of n entries)")
    dev = consts.V.device
    replay = _replaying(dev, comm, segment)
    length = segment or (_GRAPH_SEGMENT.get(method, REFRESH_EVERY) if replay else 1)
    first, done = torch.stack([state.itr, state.done.to(state.itr.dtype)]).tolist()
    plan = segments(first, 0 if done else itrs, length)
    latches = not sampling or state.idcs.shape[0] > 0
    carry = _carry(consts, state, first + int(itrs), comm)
    replay = replay and not done and itrs > 0
    drawing = contextlib.nullcontext()
    if replay:
        step, c, drawing = _replayer(consts, carry, method, tol, draws, matvec_k)
    else:
        nsum, cdf = _derived(consts, method, comm)
        shard_cdf = None
        if sampling:
            draws = as_draws(draws if draws is not None else torch.Generator(device=dev))
            if comm is not None:
                carry = carry._replace(T0=comm.sum(carry.T0, "setup"))
                shard_cdf = torch.cumsum(comm.slots(cdf[-1], "setup"), dim=0)
        p = _Problem(consts, method, tol, matvec_k, comm, draws, cdf, shard_cdf, nsum)
        step = functools.partial(_segment, p)
        # the state's own tensors: the weights (the sampling solvers'
        # counts) and, on the fused route, the rest are updated in place
        c = carry._replace(**{k: t.clone() for k, t in carry.state()._asdict().items()})
    itr = first
    with drawing:
        for start, n, refresh in plan:
            c = step(c, n, refresh)
            itrs_run += n
            itr, done = _read(c, start + n, latches)
            if done:
                break
    if replay:                      # out of the static buffers
        c = _Carry(*(t.clone() for t in c))
    s = c.state()
    if method in ("giga", "frankwolfe"):
        # fold the carried scale back: callers always see TRUE weights
        s = s._replace(w=c.wscale * s.w)
    elif sampling and itr > first:
        # the weights follow the counts.  Only the last draw can have been
        # refused (it ended the loop); if that was the first, the weights
        # stay as they were found
        T = c.T0 + (c.itr - c.itr0).to(c.T0.dtype) - c.last_over.to(c.T0.dtype)
        s = s._replace(w=torch.where(c.first_ok, _sampling_weights(consts, s.cts, T), s.w))
    return s


def _optimize_core(consts: SNNLSConsts, w, xw, done, idcs, size, tol: float,
                   num_iters: int, comm=None):
    """The re-solve on device values alone, nothing read back to the host
    (``optimize_active_core`` there): (w, xw, done, ok)."""
    mask, safe = _active_mask(idcs, size)
    Aact, (prev_w_act,) = _gather(consts, safe, comm, (w,), mask=mask, kind="rows")
    w_act = nnls_rows(Aact, consts.b, mask, num_iters=num_iters)
    w2 = _scatter(w, safe, mask, w_act, comm)
    xw2 = w_act @ Aact
    prev_cost = _cached_error(consts, prev_w_act @ Aact)
    ok = _cached_error(consts, xw2) <= prev_cost * (1.0 + tol)
    return torch.where(ok, w2, w), torch.where(ok, xw2, xw), done | ~ok, ok


def optimize_active(consts: SNNLSConsts, state: SNNLSState, idcs: torch.Tensor,
                    size: int, tol: float, num_iters: int = 512, comm=None):
    """Re-solve the weights on the active set (snnls/snnls.py:81-97).

    ``idcs`` are the active column indices, padded, covering ALL w>0
    entries; ``size`` the number of live ones.  The (K, K) solve is FISTA
    (:mod:`.nnls`), a fixed number of steps with nothing read back (the
    JAX package's ``fori_loop``); on a CUDA device without ``comm`` it is
    one replayed CUDA graph per padded size (:mod:`.graphs`), with ``size``
    an input, shared as a build's graphs are (:func:`_graph_set`).  Returns
    the new state and whether the cost did not rise: if it rose, the
    weights are kept and ``done`` latches.  Sharded
    (``comm``): the active rows and weights come in one (K, S + 1)
    exchange, the solve runs on every rank, and each writes its own rows.
    """
    dev = consts.V.device
    if dev.type != "cuda" or comm is not None:
        w, xw, done, ok = _optimize_core(consts, state.w, state.xw, state.done, idcs, size,
                                         tol, num_iters, comm)
        return state._replace(w=w, xw=xw, done=done), ok
    inputs = (state.w, state.xw, state.done, idcs.to(device=dev, dtype=torch.int32),
              torch.full((), int(size), dtype=torch.int32, device=dev))
    key = ("optimize", float(tol), int(num_iters), tuple((t.dtype, tuple(t.shape)) for t in inputs))
    e, sc = _graph_set(consts, key, None,
                       lambda: [torch.empty_like(t) for t in inputs]
                       + [torch.empty((), dtype=torch.bool, device=dev)])
    st = e.static                                   # w, xw, done, idcs, size, ok
    graphs.copy_into(st, inputs)
    e.run(None, lambda: graphs.copy_into(st[:3] + st[5:], _optimize_core(sc, *st[:5], tol,
                                                                      num_iters)))
    w, xw, done, ok = (t.clone() for t in st[:3] + st[5:])
    return state._replace(w=w, xw=xw, done=done), ok


def _active_set(state: SNNLSState, comm=None):
    """Tracked-support (indices, weights) — a small fixed-size transfer
    (sharded: one (K,) exchange of the owners' weights)."""
    K = state.idcs.shape[0]
    mask = torch.arange(K, device=state.idcs.device) < state.size
    safe = torch.where(mask, state.idcs, 0)
    if comm is None:
        vals = state.w.index_select(0, safe)
    else:
        j, mine = comm.local(safe)
        vals = comm.owned(state.w.index_select(0, j), mine, "gather")
    return torch.where(mask, safe, -1), torch.where(mask, vals, 0.0)


class SparseNNLS:
    """Stateful facade with the reference's user-facing API
    (snnls/snnls.py:8-106): ``build(itrs)``, ``weights()``, ``error()``,
    ``size()``, ``reset()`` and the ``reached_numeric_limit`` latch.  The
    subclasses name the solver (``method``).

    The problem lives on A's device: a tensor's own, else ``device``, else
    the default device (the CUDA card); ``b`` and ``valid`` go there, and a
    tensor of theirs on another device raises.
    ``seed`` seeds the sampling solvers' generator, which lives on that
    device too; ``reset()`` re-seeds it.  The greedy solvers draw nothing.
    :meth:`from_consts` wraps constants made elsewhere, such as the
    int8-resident ones of :func:`make_consts_quantized`.
    ``optimize()`` re-solves the active weights (FISTA on the device, or
    exact Lawson-Hanson on the host); ``save``/``restore`` and
    ``build(checkpoint_path=...)`` checkpoint the solver state and the
    generator's.

    Made by ``from_consts(consts, mesh=...)`` from one rank's block of a
    row-sharded problem, every method is collective (all ranks call it) and
    ``comm`` holds the rank's exchanges: ``weights()`` and ``active()``
    return the global arrays on every rank, with one exchange each, and a
    checkpoint is one file per rank (``<path>.rank<r>-of-<world>``).
    """

    comm = None

    method = "giga"

    def __init__(self, A, b, valid=None, seed: int = 0, max_active: int | None = None,
                 select_dtype=None, device=None):
        A = config.as_tensor(A, config.default_dtype(), device)
        b = config.on_device(b, config.default_dtype(), A.device, "b")
        requested = (torch.ones(A.shape[1], dtype=torch.bool, device=A.device)
                     if valid is None else config.on_device(valid, torch.bool, A.device, "valid"))
        sampling = self.method if self.method in ("importance", "uniform") else None
        self.consts = make_consts(A, b, valid=requested, select_dtype=select_dtype,
                                  sampling=sampling)
        # the reference's zero-column rejection (giga.py:11-13), for the
        # greedy solvers only; explicitly masked (padded) columns are exempt
        if sampling is None and bool(torch.any(requested & ~self.consts.valid)):
            raise ValueError(f"{type(self).__name__}: A must not have any 0 columns")
        self._setup(seed, max_active)

    @classmethod
    def from_consts(cls, consts: SNNLSConsts, seed: int = 0, max_active: int | None = None,
                    mesh=None):
        """The solver on constants made elsewhere (ops/snnls.py:1087-1120 of
        the JAX package), e.g. the int8-resident constants of
        :func:`make_consts_quantized`, without forming A again.  Zero rows
        must already be ``valid=False``; the sampling solvers need
        constants made with their ``sampling=``.

        ``mesh`` (``parallel.make_mesh``): ``consts`` are this rank's block
        of a problem row-sharded over the mesh's data axis
        (``parallel.shard_consts``, ``make_sharded_consts`` or
        ``make_streamed_quantized_consts``), every rank holding the same
        number of rows, rank r the rows from ``r * n_loc``; the solver then
        runs every operation as one rank of the sharded build."""
        self = cls.__new__(cls)
        self.consts = consts
        if mesh is not None:
            self.comm = _data_comm(mesh, consts)
        self._setup(seed, max_active)
        return self

    def _setup(self, seed: int, max_active: int | None):
        if self.method == "giga" and float(self.consts.bnorm) == 0.0:
            raise NumericalPrecisionError("norm of b must be > 0")
        n = self.consts.V.shape[0] * (1 if self.comm is None else self.comm.world)
        self._max_active = int(max_active) if max_active is not None else min(n, 1024)
        self._seed = seed
        sampling = self.method in ("importance", "uniform")
        self._gen = torch.Generator(device=self.consts.V.device) if sampling else None
        self.reset()

    def reset(self):
        if self._gen is not None:
            self._gen.manual_seed(self._seed)
        self.state = init_state(self.consts, self._max_active)

    def _path(self, path: str) -> str:
        c = self.comm
        return path if c is None else f"{path}.rank{c.rank}-of-{c.world}"

    def save(self, path: str):
        """Checkpoint the solver state (resume with :meth:`restore`)."""
        checkpoint.save(self._path(path), self.state, meta={"method": self.method},
                        generator=self._gen)

    def restore(self, path: str):
        self.state, _ = checkpoint.load(self._path(path), like=self.state, generator=self._gen)

    def size(self) -> int:
        k = torch.sum(self.state.w > 0)
        return int(k if self.comm is None else self.comm.sum(k.double(), "gather"))

    def weights(self) -> np.ndarray:
        w = self.state.w if self.comm is None else self.comm.gather(self.state.w)
        return w.cpu().numpy()

    def active(self):
        """(indices, weights) of the active set as numpy arrays, extracted
        on the device: O(max_active) values cross to the host."""
        if self.state.idcs.shape[0]:
            idx, vals = (t.cpu().numpy() for t in _active_set(self.state, self.comm))
        else:
            vals = self.weights()
            idx = np.arange(vals.shape[0])
        keep = vals > 0
        return idx[keep], vals[keep]

    def error(self) -> float:
        return float(error(self.consts, self.state.w, support=self._max_active,
                           comm=self.comm))

    @property
    def reached_numeric_limit(self) -> bool:
        return bool(self.state.done)

    def build(self, itrs: int, checkpoint_path: str | None = None,
              checkpoint_every: int | None = None):
        """Run ``itrs`` greedy iterations (incremental).

        With ``checkpoint_path``, the state is saved every
        ``checkpoint_every`` iterations (default: once at the end), and a
        checkpoint found there with MORE progress than the current state is
        restored first; it only fast-forwards toward the target, which is
        relative to the current state.
        """
        if self.reached_numeric_limit or self.consts.V.numel() == 0 or itrs <= 0:
            return
        if checkpoint_path is None:
            self.state = self._run_build(itrs)
            return
        target = int(self.state.itr) + itrs
        if os.path.exists(self._path(checkpoint_path)):
            saved, _ = checkpoint.load(self._path(checkpoint_path), like=self.state)
            if int(saved.itr) > int(self.state.itr):
                self.restore(checkpoint_path)       # the generator's state too
        chunk = checkpoint_every or itrs
        while int(self.state.itr) < target and not self.reached_numeric_limit:
            step = min(chunk, target - int(self.state.itr))
            self.state = self._run_build(step)
            self.save(checkpoint_path)

    def _run_build(self, itrs: int) -> SNNLSState:
        return build(self.consts, self.state, itrs, config.TOL, method=self.method,
                     draws=self._gen, matvec_k=self._max_active, comm=self.comm)

    def optimize(self, solver: str = "fista"):
        """Re-solve the weights on the active set (snnls/snnls.py:81-97).

        ``solver="fista"``: accelerated projected gradient on the data's
        device (:func:`optimize_active`).  ``solver="exact"``: Lawson-Hanson
        in f64 on the host (:mod:`..native`), on the active rows only
        (dequantized in f64 for int8-resident constants).  Either way, a
        re-solve that raises the cost is refused and latches the numeric
        limit.
        """
        if solver not in ("fista", "exact"):
            raise ValueError(f"solver must be 'fista' or 'exact'; got {solver!r}")
        act = np.sort(self.active()[0])
        if act.size == 0:
            return
        dev, comm = self.consts.V.device, self.comm
        if solver == "exact":
            act_t = torch.as_tensor(act, device=dev)
            rows, (nrm,) = _gather(self.consts, act_t, comm, (self.consts.norms,),
                                   dequantize=False)
            Vact = rows.cpu().numpy().astype(np.float64)
            if _is_quantized(self.consts):
                Vact *= nrm.cpu().numpy()[:, None] / 127.0
            prev_err = self.error()
            x, _ = native.nnls(Vact.T, self.consts.b.double().cpu().numpy())
            w = _scatter(self.state.w, act_t, torch.ones_like(act_t, dtype=torch.bool),
                         torch.as_tensor(x, dtype=self.state.w.dtype, device=dev), comm)
            # the support bound of prev_err's, or more: the new weights may
            # have up to act.size nonzeros (ops/snnls.py:1271-1275 there)
            support = max(self._max_active, act.size)
            if float(error(self.consts, w, support=support, comm=comm)) \
                    > prev_err * (1.0 + config.TOL):
                self.state = self.state._replace(done=torch.ones_like(self.state.done))
            else:
                # the JAX package keeps the old xw here (ROADMAP Queue 3 (f))
                self.state = self.state._replace(
                    w=w, xw=_v_matvec(self.consts, w, support, comm))
            return
        pad = 1 << max(3, int(np.ceil(np.log2(act.size))))
        idcs = np.zeros(pad, dtype=np.int32)
        idcs[: act.size] = act
        self.state, _ = optimize_active(self.consts, self.state,
                                        torch.as_tensor(idcs, device=dev), act.size,
                                        config.TOL, comm=comm)


def _data_comm(mesh, consts: SNNLSConsts):
    """The exchanges of one rank of a problem row-sharded over ``mesh``'s
    data axis; checks that every rank holds as many rows as this one."""
    from ..parallel.comm import Comm
    from ..parallel.mesh import DATA_AXIS, Mesh

    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must come from parallel.make_mesh; got {type(mesh).__name__}")
    n_loc = consts.V.shape[0]
    comm = Comm(mesh, DATA_AXIS, n_loc)
    rows = comm.slots(torch.tensor(float(n_loc), dtype=torch.float64,
                                   device=consts.V.device), "setup")
    if bool(torch.any(rows != n_loc)):
        raise ValueError(f"every rank must hold the same number of rows; got "
                         f"{rows.long().tolist()} (pad with valid=False rows)")
    return comm


class GIGA(SparseNNLS):
    """Greedy iterative geodesic ascent (reference snnls/giga.py:6-64)."""

    method = "giga"


class FrankWolfe(SparseNNLS):
    """Frank-Wolfe on the scaled simplex (reference snnls/frankwolfe.py:5-40)."""

    method = "frankwolfe"


class OrthoPursuit(SparseNNLS):
    """Orthogonal matching pursuit with a full NNLS re-solve on the active
    set per iteration (reference snnls/orthopursuit.py:7-42)."""

    method = "orthopursuit"


class ImportanceSampling(SparseNNLS):
    """Sampling with probabilities proportional to the columns' norms
    (reference snnls/sampling.py:6-37)."""

    method = "importance"


class UniformSampling(SparseNNLS):
    """Sampling uniformly over the valid columns (reference
    snnls/sampling.py:6-37)."""

    method = "uniform"
