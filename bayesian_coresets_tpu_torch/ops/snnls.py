"""Sparse non-negative least squares by GIGA, on one device.

Port of the GIGA parts of ``bayesian_coresets_tpu/ops/snnls.py`` (reference
``bayesiancoresets/snnls/snnls.py`` and ``giga.py``).  The algebra is the
JAX package's, step for step:

- **Incremental O(S) reweighting.**  Every step has the form
  ``w <- alpha*w; w[f] = new``, so the cached image ``xw = A @ w`` updates
  as ``alpha*xw + delta*A[:, f]``; an exact refresh from the tracked
  support runs every ``REFRESH_EVERY`` iterations to bound f32 drift.
- **Scale-carried weights.**  The global ``alpha`` rescale rides a scalar
  (``GigaAux.wscale``): only index f is written per iteration, and the
  scale folds into the weights when it would underflow and once on return.
- **Flags, not exceptions.**  A failed step is discarded and counted; two
  consecutive failures, or selecting more distinct atoms than
  ``max_active``, latch ``done`` (reference snnls.py:40-74).
- **Data-point-major layout.**  ``V = A.T`` is (n, S); the select streams
  a reduced-precision copy ``Vsel`` once per iteration through the fused
  kernel of :mod:`.giga_select`.

Where the JAX package runs the whole build as one ``lax.while_loop``, this
is an eager Python loop over the same step.  The iteration count is kept on
the host (so the refresh cadence needs no device read), and the three
conditions that depend on the device (the loop guard ``done``, the wscale
fold, and the overflow latch, which feeds ``done``) come back in ONE small
device-to-host transfer per iteration.  The weight vector is updated in
place: ``build`` copies it once on entry.

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

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..utils import checkpoint, config
from ..utils.errors import NumericalPrecisionError
from .giga_select import col_multiple, giga_select, sqrt_rn
from .nnls import nnls_rows

REFRESH_EVERY = 64      # exact xw = A@w recompute cadence (f32 drift control)
_WSCALE_FLOOR = 1e-10   # fold the carried scale into w before it underflows


class SNNLSConsts(NamedTuple):
    """Problem constants."""

    V: torch.Tensor       # (n, S) = A.T, rows are per-datum feature vectors
    b: torch.Tensor       # (S,) target vector
    norms: torch.Tensor   # (n,) row norms ||V[i]|| (1 for invalid rows)
    bnorm: torch.Tensor   # 0-dim ||b||
    valid: torch.Tensor   # (n,) bool mask of selectable rows
    Vsel: torch.Tensor    # (n, Sp) select-phase copy of V, columns zero-padded
    #                       to whole 16-byte rows (the kernel's load width):
    #                       - float32: V itself (aliased when S needs no pad)
    #                       - bfloat16: half the bytes per select pass
    #                       - int8: a quarter; rows PRE-NORMALIZED and scaled
    #                         to ±127 (the /norms division folds into the
    #                         dequantization constant 1/127^2)


class SNNLSState(NamedTuple):
    """Solver state carried through the build loop."""

    w: torch.Tensor       # (n,) weights
    xw: torch.Tensor      # (S,) cached A @ w
    idcs: torch.Tensor    # (K,) int32 active-slot indices (-1 = empty)
    size: torch.Tensor    # int32 number of active slots
    itr: torch.Tensor     # int32 total iterations attempted (lifetime)
    fail: torch.Tensor    # int32 consecutive failed iterations
    done: torch.Tensor    # bool: numeric limit latched (snnls/snnls.py:66-69)


def _pad_cols(x: torch.Tensor, mult: int) -> torch.Tensor:
    S = x.shape[1]
    Sp = -(-S // mult) * mult
    return x if Sp == S else F.pad(x, (0, Sp - S))


def make_consts(A: torch.Tensor, b: torch.Tensor, valid: torch.Tensor | None = None,
                select_dtype: torch.dtype | None = None) -> SNNLSConsts:
    """Precompute solver constants from A (S, n) and b (S,), on A's device.

    ``select_dtype`` (``torch.bfloat16`` or ``torch.int8``) stores a
    reduced-precision copy of V used only by the select; all weight and
    error arithmetic stays f32.
    """
    V = A.T.contiguous()
    b = b.to(V.device)
    if valid is None:
        valid = torch.ones(V.shape[0], dtype=torch.bool, device=V.device)
    norms = torch.sqrt(torch.sum(V * V, dim=1))
    valid = valid.to(V.device) & (norms > 0)
    norms = torch.where(valid, norms, 1.0)
    bnorm = torch.sqrt(torch.sum(b * b))
    if select_dtype is None or select_dtype == V.dtype:
        Vsel = V
    elif select_dtype == torch.int8:
        Vn = V / norms[:, None]
        Vsel = torch.clamp(torch.round(Vn * 127.0), -127, 127).to(torch.int8)
    elif select_dtype == torch.bfloat16:
        Vsel = V.to(torch.bfloat16)
    else:
        raise ValueError(f"select_dtype must be None, bfloat16 or int8; got {select_dtype}")
    Vsel = _pad_cols(Vsel, col_multiple(Vsel.dtype))
    return SNNLSConsts(V, b, norms, bnorm, valid, Vsel)


def init_state(consts: SNNLSConsts, max_active: int = 0) -> SNNLSState:
    n, S = consts.V.shape
    dev, dt = consts.V.device, consts.V.dtype
    i32 = dict(dtype=torch.int32, device=dev)
    return SNNLSState(
        w=torch.zeros(n, dtype=dt, device=dev),
        xw=torch.zeros(S, dtype=dt, device=dev),
        idcs=torch.full((max_active,), -1, **i32),
        size=torch.zeros((), **i32),
        itr=torch.zeros((), **i32),
        fail=torch.zeros((), **i32),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _v_row(consts: SNNLSConsts, fl: torch.Tensor) -> torch.Tensor:
    """Row V[f] in f32; ``fl`` is the (1,) int64 index tensor."""
    return consts.V.index_select(0, fl)[0]


def _v_matvec(consts: SNNLSConsts, w: torch.Tensor) -> torch.Tensor:
    """V^T @ w in f32 (dense)."""
    return consts.V.T @ w


def error(consts: SNNLSConsts, w: torch.Tensor) -> torch.Tensor:
    """||A w - b||_2 (snnls/snnls.py:28-29)."""
    return _cached_error(consts, _v_matvec(consts, w))


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 result of a product accumulated in f64 (order-independent)."""
    return (x.double() @ y.double()).float()


def _cached_error(consts: SNNLSConsts, xw: torch.Tensor) -> torch.Tensor:
    r = (xw - consts.b).double()
    return sqrt_rn(_dot(r, r))


def _track_support(state: SNNLSState, f: torch.Tensor):
    """Insert f into the active-slot list if new.

    Slots are capped at ``max_active``; selecting MORE distinct atoms than
    that is a capacity overflow, returned third so the build loop refuses
    the step and latches ``done`` — the tracked support, and therefore the
    refreshes, must never silently drop a live atom.
    """
    K = state.idcs.shape[0]
    if K == 0:
        return state.idcs, state.size, torch.zeros((), dtype=torch.bool,
                                                   device=state.idcs.device)
    slots = torch.arange(K, device=state.idcs.device)
    already = torch.any((state.idcs == f) & (slots < state.size))
    overflow = ~already & (state.size >= K)
    keep = already | overflow
    slot = torch.clamp(state.size, max=K - 1)
    idcs = torch.where((slots == slot) & ~keep, f, state.idcs)
    size = torch.where(keep, state.size, state.size + 1)
    return idcs, size, overflow


def _support_matvec(consts: SNNLSConsts, w, idcs, size) -> torch.Tensor:
    """Exact V^T w via the tracked support (w>0 entries all lie in idcs)."""
    mask = torch.arange(idcs.shape[0], device=idcs.device) < size
    safe = torch.where(mask, idcs, 0)
    rows = torch.where(mask[:, None], consts.V.index_select(0, safe), 0.0)
    return _dot(torch.where(mask, w.index_select(0, safe), 0.0), rows)


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


def _aux_from_xw(consts: SNNLSConsts, xw: torch.Tensor, wscale=1.0) -> GigaAux:
    return GigaAux(_dot(consts.b, xw), _dot(xw, xw),
                   _cached_error(consts, xw),
                   torch.as_tensor(wscale, dtype=torch.float32, device=xw.device))


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


def _giga_step(consts: SNNLSConsts, state: SNNLSState, aux: GigaAux,
               tol: float) -> GigaStep:
    bnorm = torch.where(consts.bnorm == 0, 1.0, consts.bnorm)
    bn = consts.b / bnorm
    nw = sqrt_rn(torch.clamp_min(aux.nw2, 0.0))
    nw_safe = torch.where(nw == 0, 1.0, nw)
    xwn = state.xw / nw_safe
    bxwn = aux.bxw / (bnorm * nw_safe)                 # <bn, xwn>

    # cdir = bn - <bn,xwn> xwn has ||cdir||^2 = 1 - <bn,xwn>^2 exactly
    cdir = bn - bxwn * xwn
    cdirnrm = sqrt_rn(torch.clamp_min(1.0 - bxwn * bxwn, 0.0))
    ok_sel = cdirnrm >= tol                            # giga.py:27-29
    cdirn = cdir / torch.where(cdirnrm == 0, 1.0, cdirnrm)

    # scores for every candidate and their argmax: one pass over Vsel
    dirs = torch.stack([cdirn, xwn], dim=1)            # (S, 2), unit columns
    f, _ = giga_select(consts.Vsel, dirs, consts.norms, consts.valid)
    fl = f.long().view(1)

    # reweight (giga.py:40-64): one row gather + one (2,S) matvec + scalars
    xf = _v_row(consts, fl)
    nf = consts.norms.index_select(0, fl)[0]
    xfn = xf / nf
    two = _dot(torch.stack([bn, xwn]), xfn)
    bxf, xwxf = two[0], two[1]                         # <bn,xfn>, <xwn,xfn>
    gA = bxf - bxwn * xwxf
    gB = bxwn - bxf * xwxf
    ok_rw = (gA > 0.0) & (gB >= 0.0)                   # giga.py:50-51

    gsum = torch.where(gA + gB == 0, 1.0, gA + gB)
    a = gB / gsum / nw_safe
    c = gA / gsum / nf
    # x = a*xw + c*xf never materializes; the optimal scaling
    # (giga.py:56-60) is (x.b) / ||x||^2, all scalars
    xw_xf = nw_safe * nf * xwxf
    b_xf = bnorm * nf * bxf
    nx2 = a * a * aux.nw2 + 2.0 * a * c * xw_xf + c * c * nf * nf
    x_b = a * aux.bxw + c * b_xf
    scale = x_b / torch.where(nx2 == 0, 1.0, nx2)
    alpha, beta = a * scale, c * scale

    ws = aux.wscale
    old_raw = state.w.index_select(0, fl)[0]
    old_wf = ws * old_raw
    new_wf = torch.clamp_min(alpha * old_wf + beta, 0.0)
    delta = new_wf - alpha * old_wf
    xw2 = alpha * state.xw + delta * xf                # xw stays TRUE-scale
    aux2 = _aux_from_xw(consts, xw2)

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
    commit = ok & ~overflow

    aux_out = GigaAux(bxw=torch.where(commit, aux2.bxw, aux.bxw),
                      nw2=torch.where(commit, aux2.nw2, aux.nw2),
                      err=torch.where(commit, aux2.err, aux.err),
                      wscale=ws)
    ws2 = alpha * ws
    return GigaStep(fl, ws2, ws2 < _WSCALE_FLOOR, new_wf, old_raw, xw2, commit,
                    ok, overflow, idcs2, size2, aux_out)


def _carried_commit(state: SNNLSState, st: GigaStep, fold_commit: bool):
    """Commit a scale-carried rank-1 update: the global alpha rescale folds
    into wscale, and only index f of the weights is written — in place.
    ``fold_commit`` (read on the host) says the scale would underflow and
    the step commits: then the scale is folded into every weight first
    (the O(n) pass of the JAX package's ``lax.cond``)."""
    w = state.w
    if fold_commit:
        w.mul_(st.ws2)
        w.index_copy_(0, st.fl, st.new_wf.view(1))
    else:
        raw = torch.where(st.commit,
                          st.new_wf / torch.where(st.fold, 1.0, st.ws2), st.old_raw)
        w.index_copy_(0, st.fl, raw.view(1))
    ws_out = torch.where(st.commit, torch.where(st.fold, 1.0, st.ws2), st.aux.wscale)
    return (w,
            torch.where(st.commit, st.xw2, state.xw),
            torch.where(st.commit, st.idcs2, state.idcs),
            torch.where(st.commit, st.size2, state.size),
            st.aux._replace(wscale=ws_out))


def build(consts: SNNLSConsts, state: SNNLSState, itrs: int, tol: float) -> SNNLSState:
    """Run up to ``itrs`` GIGA iterations, continuing from ``state``.

    Port of the JAX package's ``build_core``/``build`` for
    ``method="giga"`` (the only solver ported).  Returns a new state with
    TRUE-scale weights; ``state`` itself is left unchanged.
    """
    dev = consts.V.device
    itr = int(state.itr)
    itr_end = itr + int(itrs)
    done = bool(state.done)
    K = state.idcs.shape[0]
    s = state._replace(w=state.w.clone())
    aux = _aux_from_xw(consts, s.xw)
    while itr < itr_end and not done:
        if itr % REFRESH_EVERY == 0:
            # exact refresh of the cached matvec AND the scalar cache; with
            # support slots it gathers only the tracked rows (O(K*S))
            exact = (_support_matvec(consts, s.w, s.idcs, s.size) if K
                     else _v_matvec(consts, s.w))
            xw = aux.wscale * exact       # state.w is raw-scale
            aux = _aux_from_xw(consts, xw, wscale=aux.wscale)
            s = s._replace(xw=xw)
        st = _giga_step(consts, s, aux, tol)
        fail = torch.where(st.ok, 0, s.fail + 1)
        # retry-once-then-latch; a support-capacity overflow latches at once
        done_t = s.done | (fail >= 2) | st.overflow
        fold_commit, done = torch.stack([st.fold & st.commit, done_t]).tolist()
        w, xw, idcs, size, aux = _carried_commit(s, st, fold_commit)
        s = SNNLSState(w, xw, idcs, size, s.itr, fail, done_t)
        itr += 1
    # fold the carried scale back: callers always see TRUE weights
    return s._replace(w=aux.wscale * s.w,
                      itr=torch.tensor(itr, dtype=torch.int32, device=dev))


def optimize_active(consts: SNNLSConsts, state: SNNLSState, idcs: torch.Tensor,
                    size: int, tol: float, num_iters: int = 512):
    """Re-solve the weights on the active set (snnls/snnls.py:81-97).

    ``idcs`` are the active column indices, padded, covering ALL w>0
    entries; ``size`` the number of live ones.  The (K, K) solve is FISTA
    (:mod:`.nnls`).  Returns the new state and whether the cost did not
    rise: if it rose, the weights are kept and ``done`` latches.
    """
    mask = torch.arange(idcs.shape[0], device=idcs.device) < size
    safe = torch.where(mask, idcs, 0).long()
    Aact = torch.where(mask[:, None], consts.V.index_select(0, safe), 0.0)
    w_act = nnls_rows(Aact, consts.b, mask, num_iters=num_iters)
    w = torch.zeros_like(state.w).index_add_(0, safe, torch.where(mask, w_act, 0.0))
    xw = w_act @ Aact
    prev_w_act = torch.where(mask, state.w.index_select(0, safe), 0.0)
    prev_cost = _cached_error(consts, prev_w_act @ Aact)
    ok = _cached_error(consts, xw) <= prev_cost * (1.0 + tol)
    return state._replace(w=torch.where(ok, w, state.w),
                          xw=torch.where(ok, xw, state.xw),
                          done=state.done | ~ok), ok


def _active_set(state: SNNLSState):
    """Tracked-support (indices, weights) — a small fixed-size transfer."""
    K = state.idcs.shape[0]
    mask = torch.arange(K, device=state.idcs.device) < state.size
    safe = torch.where(mask, state.idcs, 0)
    return (torch.where(mask, safe, -1),
            torch.where(mask, state.w.index_select(0, safe), 0.0))


class SparseNNLS:
    """Stateful facade with the reference's user-facing API
    (snnls/snnls.py:8-106): ``build(itrs)``, ``weights()``, ``error()``,
    ``size()``, ``reset()`` and the ``reached_numeric_limit`` latch.

    The problem lives on A's device: a tensor's own, else ``device``, else
    the default device (the CUDA card); ``b`` and ``valid`` go there, and a
    tensor of theirs on another device raises.
    ``seed`` is kept for the reference's signature; GIGA draws nothing.
    ``optimize()`` re-solves the active weights (FISTA on the device, or
    exact Lawson-Hanson on the host); ``save``/``restore`` and
    ``build(checkpoint_path=...)`` checkpoint the solver state.
    """

    method = "giga"

    def __init__(self, A, b, valid=None, seed: int = 0, max_active: int | None = None,
                 select_dtype=None, device=None):
        A = config.as_tensor(A, config.default_dtype(), device)
        b = config.on_device(b, config.default_dtype(), A.device, "b")
        requested = (torch.ones(A.shape[1], dtype=torch.bool, device=A.device)
                     if valid is None else config.on_device(valid, torch.bool, A.device, "valid"))
        self.consts = make_consts(A, b, valid=requested, select_dtype=select_dtype)
        # the reference's zero-column rejection (giga.py:11-13); explicitly
        # masked (padded) columns are exempt
        if bool(torch.any(requested & ~self.consts.valid)):
            raise ValueError(f"{type(self).__name__}: A must not have any 0 columns")
        if float(self.consts.bnorm) == 0.0:
            raise NumericalPrecisionError("norm of b must be > 0")
        n = self.consts.V.shape[0]
        self._max_active = int(max_active) if max_active is not None else min(n, 1024)
        self.state = init_state(self.consts, self._max_active)

    def reset(self):
        self.state = init_state(self.consts, self._max_active)

    def save(self, path: str):
        """Checkpoint the solver state (resume with :meth:`restore`)."""
        checkpoint.save(path, self.state, meta={"method": self.method})

    def restore(self, path: str):
        self.state, _ = checkpoint.load(path, like=self.state)

    def size(self) -> int:
        return int(torch.sum(self.state.w > 0))

    def weights(self) -> np.ndarray:
        return self.state.w.cpu().numpy()

    def active(self):
        """(indices, weights) of the active set as numpy arrays, extracted
        on the device: O(max_active) values cross to the host."""
        if self.state.idcs.shape[0]:
            idx, vals = (t.cpu().numpy() for t in _active_set(self.state))
        else:
            vals = self.weights()
            idx = np.arange(vals.shape[0])
        keep = vals > 0
        return idx[keep], vals[keep]

    def error(self) -> float:
        return float(error(self.consts, self.state.w))

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
            self.state = build(self.consts, self.state, itrs, config.TOL)
            return
        target = int(self.state.itr) + itrs
        if os.path.exists(checkpoint_path):
            saved, _ = checkpoint.load(checkpoint_path, like=self.state)
            if int(saved.itr) > int(self.state.itr):
                self.state = saved
        chunk = checkpoint_every or itrs
        while int(self.state.itr) < target and not self.reached_numeric_limit:
            step = min(chunk, target - int(self.state.itr))
            self.state = build(self.consts, self.state, step, config.TOL)
            self.save(checkpoint_path)

    def optimize(self, solver: str = "fista"):
        """Re-solve the weights on the active set (snnls/snnls.py:81-97).

        ``solver="fista"``: accelerated projected gradient on the data's
        device (:func:`optimize_active`).  ``solver="exact"``: Lawson-Hanson
        in f64 on the host (:mod:`..native`), on the active rows only.  Either
        way, a re-solve that raises the cost is refused and latches the
        numeric limit.
        """
        if solver not in ("fista", "exact"):
            raise ValueError(f"solver must be 'fista' or 'exact'; got {solver!r}")
        act = np.sort(self.active()[0])
        if act.size == 0:
            return
        dev = self.consts.V.device
        if solver == "exact":
            act_t = torch.as_tensor(act, device=dev)
            Vact = self.consts.V.index_select(0, act_t).double().cpu().numpy()
            prev_err = self.error()
            x, _ = native.nnls(Vact.T, self.consts.b.double().cpu().numpy())
            w = torch.zeros_like(self.state.w)
            w[act_t] = torch.as_tensor(x, dtype=w.dtype, device=dev)
            if float(error(self.consts, w)) > prev_err * (1.0 + config.TOL):
                self.state = self.state._replace(done=torch.ones_like(self.state.done))
            else:
                # the JAX package keeps the old xw here (ROADMAP Queue 3 (f))
                self.state = self.state._replace(w=w, xw=_v_matvec(self.consts, w))
            return
        pad = 1 << max(3, int(np.ceil(np.log2(act.size))))
        idcs = np.zeros(pad, dtype=np.int32)
        idcs[: act.size] = act
        self.state, _ = optimize_active(self.consts, self.state,
                                        torch.as_tensor(idcs, device=dev), act.size,
                                        config.TOL)


class GIGA(SparseNNLS):
    """Greedy iterative geodesic ascent (reference snnls/giga.py:6-64)."""
