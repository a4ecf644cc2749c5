"""One GIGA iteration's arithmetic around the select, fused on the card.

A GIGA iteration of ``ops/snnls.py`` is the select and, around it, the step
(:func:`frame`, the directions, the reweight of :func:`reweight`, the new
``xw`` and its scalar cache, the monotone check, the support slots of
:func:`track`), the where-gated commit and the loop's bookkeeping
(``fail``, ``done``, ``itr`` under ``live = (itr < itr_end) & ~done``).  As
PyTorch ops these are ~165 kernels on 0-dim values and S-vectors.  Here
they are two hand-written single-block kernels (``csrc/giga_step.cu``), and
an iteration is four launches::

    step = Step(consts, c, tol)   # checks once; the first directions
    for each iteration:
        step.iterate()            # the select, update, the fold, finish

``consts`` has the fields ``V``, ``b``, ``norms``, ``bnorm``, ``valid`` and
``Vsel`` of ``snnls.SNNLSConsts`` (V float32, or int8-resident: rows ``q *
norms / 127``); ``c`` is the build's carry (``snnls._Carry``), whose
fields ``w``, ``xw``, ``idcs``, ``size``, ``itr``, ``fail``, ``done``,
``bxw``, ``nw2``, ``err`` and ``wscale`` the iterations update in place; the
:class:`Work` holds the directions, the select's output and what the
update hands the fold and the finish.  The weight write follows the fold,
as ``snnls._carried_commit`` orders them: when the fold fires, the written
weight is ``new_wf`` itself.

On CUDA tensors each step launches its kernel on the current stream,
without synchronizing or allocating; on CPU tensors it runs its plain
version, built from the plain route's own pieces (``snnls._giga_step``
after its select, ``_carried_commit`` and the loop's gating); there is no
other route and no fallback.  The select goes through
:func:`.giga_select.giga_select_into`, looked up at each call, as every
GIGA select of the program does.  ``launches`` counts the update kernel's
launches, one per iteration, and ``dirs_launches`` the directions
kernel's, once per iteration and once per :class:`Step`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda_build
from .fold_scale import fold_scale
from . import giga_select as gs
from .giga_select import sqrt_rn

WSCALE_FLOOR = 1e-10    # fold the carried scale into w before it underflows

launches = 0            # update kernel launches (plain-version calls not counted)
dirs_launches = 0       # directions kernel launches


class Work(NamedTuple):
    """Scratch of the fused iterations, made by :func:`work`."""

    dirs: torch.Tensor    # (S, 2) f32: the select's directions [cdir_n, xw_n]
    f: torch.Tensor       # (1,) int32: the selected row (the select's index)
    score: torch.Tensor   # (1,) f32: its score
    commit: torch.Tensor  # bool: the step commits
    fold: torch.Tensor    # bool: it commits and folds the scale (fold_scale's flag)
    ws2: torch.Tensor     # f32: alpha * wscale (fold_scale's scale)
    raw: torch.Tensor     # f32: the raw weight that finish writes to w[f]


def work(xw: torch.Tensor) -> Work:
    """Scratch for iterations on the state whose ``xw`` this is
    (uninitialized: each field is written before it is read)."""
    dev = xw.device

    def scalar(dtype):
        return torch.empty((), dtype=dtype, device=dev)

    return Work(torch.empty((xw.shape[0], 2), dtype=torch.float32, device=dev),
                torch.empty(1, dtype=torch.int32, device=dev),
                torch.empty(1, dtype=torch.float32, device=dev), scalar(torch.bool),
                scalar(torch.bool), scalar(torch.float32), scalar(torch.float32))


# ---------------------------------------------------------------------------
# The arithmetic, as torch ops.  ``snnls._giga_step`` computes its step with
# these functions, and the plain versions below with them; the kernels do
# the same operations in the same order.
# ---------------------------------------------------------------------------


def frame(bnorm, bxw, nw2):
    """(bnorm, nw, bxwn, cdirnrm) of the state: b's norm and xw's, each 1
    where 0, ``bxwn = <b/|b|, xw/|xw|>``, and the norm of ``cdir = bn - bxwn
    xwn``, which is ``sqrt(1 - bxwn^2)`` exactly (reference giga.py:22-29)."""
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    nw = sqrt_rn(torch.clamp_min(nw2, 0.0))
    nw = torch.where(nw == 0, 1.0, nw)
    bxwn = bxw / (bnorm * nw)
    return bnorm, nw, bxwn, sqrt_rn(torch.clamp_min(1.0 - bxwn * bxwn, 0.0))


def unit_directions(b, xw, bnorm, nw, bxwn, cdirnrm):
    """(bn, xwn, cdirn): b and xw normalized, and cdir = bn - bxwn xwn
    normalized (a zero cdir divides by 1); ``bnorm``, ``nw``, ``bxwn``,
    ``cdirnrm`` as :func:`frame` gives them."""
    bn = b / bnorm
    xwn = xw / nw
    cdir = bn - bxwn * xwn
    return bn, xwn, cdir / torch.where(cdirnrm == 0, 1.0, cdirnrm)


def reweight(bnorm, nw, bxwn, bxw, nw2, nf, bxf, xwxf, ws, old_raw):
    """The reweight of the selected row f (giga.py:40-64), all scalars:
    (ok_rw, alpha, new_wf, delta), where ``bxf = <bn, xf/nf>``, ``xwxf =
    <xwn, xf/nf>``, ``nf`` f's norm, ``ws`` the carried scale and
    ``old_raw`` f's raw weight.  The new weights are ``alpha * w`` with
    ``w[f] = new_wf``, and ``xw <- alpha xw + delta xf``."""
    gA = bxf - bxwn * xwxf
    gB = bxwn - bxf * xwxf
    ok_rw = (gA > 0.0) & (gB >= 0.0)                   # giga.py:50-51
    gsum = torch.where(gA + gB == 0, 1.0, gA + gB)
    a = gB / gsum / nw
    c = gA / gsum / nf
    # x = a*xw + c*xf never materializes; the optimal scaling
    # (giga.py:56-60) is (x.b) / ||x||^2, all scalars
    xw_xf = nw * nf * xwxf
    b_xf = bnorm * nf * bxf
    nx2 = a * a * nw2 + 2.0 * a * c * xw_xf + c * c * nf * nf
    x_b = a * bxw + c * b_xf
    scale = x_b / torch.where(nx2 == 0, 1.0, nx2)
    alpha, beta = a * scale, c * scale
    old_wf = ws * old_raw
    new_wf = torch.clamp_min(alpha * old_wf + beta, 0.0)
    return ok_rw, alpha, new_wf, new_wf - alpha * old_wf


def track(idcs, size, f):
    """(idcs, size, overflow) with f inserted into the K > 0 active slots
    ``idcs[:size]`` if it is not there; inserting past K is an overflow and
    changes nothing."""
    K = idcs.shape[0]
    slots = torch.arange(K, device=idcs.device)
    already = torch.any((idcs == f) & (slots < size))
    overflow = ~already & (size >= K)
    keep = already | overflow
    slot = torch.clamp(size, max=K - 1)
    idcs = torch.where((slots == slot) & ~keep, f, idcs)
    return idcs, torch.where(keep, size, size + 1), overflow


# ---------------------------------------------------------------------------
# Plain versions: the plain route's own pieces (``snnls._giga_frame``,
# ``_giga_reweight``, ``_gated_commit``, ``_raw`` and ``_advance``), the
# select's index taken from the work
# ---------------------------------------------------------------------------


def directions_ref(consts, c, work: Work) -> None:
    """Plain version of :meth:`Step.directions`."""
    sc = frame(consts.bnorm, c.bxw, c.nw2)
    _, xwn, cdirn = unit_directions(consts.b, c.xw, *sc)
    work.dirs.copy_(torch.stack([cdirn, xwn], dim=1))


def update_ref(consts, c, tol: float, work: Work) -> None:
    """Plain version of :meth:`Step.update`: ``snnls._giga_step`` after the
    select, ``_carried_commit`` but for the fold and the weight write, and
    the loop's gating, in place."""
    from . import snnls                     # snnls imports this module
    s, aux = c.state(), c.aux()
    live = (c.itr < c.itr_end) & ~c.done
    st = snnls._giga_reweight(consts, s, aux, tol, snnls._giga_frame(consts, s, aux),
                              work.f[0], live=live)
    xw, idcs, size, aux2 = snnls._gated_commit(s, st)
    fail = torch.where(st.ok, 0, s.fail + 1)
    s2 = snnls._advance(s, fail, (fail >= 2) | st.overflow, live)
    for t, v in ((work.commit, st.commit), (work.fold, st.fold & st.commit),
                 (work.ws2, st.ws2), (work.raw, snnls._raw(st)), (c.xw, xw), (c.idcs, idcs),
                 (c.size, size), (c.bxw, aux2.bxw), (c.nw2, aux2.nw2), (c.err, aux2.err),
                 (c.wscale, aux2.wscale), (c.fail, s2.fail), (c.done, s2.done),
                 (c.itr, s2.itr)):
        t.copy_(v)


def finish_ref(consts, c, work: Work) -> None:
    """Plain version of :meth:`Step.finish`."""
    fl = work.f.long()
    c.w.index_copy_(0, fl, torch.where(work.commit, work.raw, c.w.index_select(0, fl)[0]).view(1))
    directions_ref(consts, c, work)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _need(t, dtype, shape, name, dev):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on {dev}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check(consts, c, work: Work) -> None:
    """Raise on what the kernels do not take."""
    V = consts.V
    if V.dim() != 2 or V.dtype not in (torch.float32, torch.int8) or V.stride(1) != 1:
        raise ValueError("V must be a 2-D float32 or int8 tensor with unit column stride; got "
                         f"{V.dtype} {tuple(V.shape)} strides {V.stride()}")
    (n, S), dev = V.shape, V.device
    b = consts.b
    if b.dtype != torch.float32 or tuple(b.shape) != (S,) or b.device != dev:
        raise ValueError(f"b must be a float32 ({S},) tensor on {dev}; got {b.dtype} "
                         f"{tuple(b.shape)} on {b.device}")
    K = c.idcs.shape[0]
    if K == 0:
        raise ValueError("the fused step tracks its support: the state needs slots")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    for t, dtype, shape, name in [
            (consts.bnorm, f32, (), "bnorm"), (consts.norms, f32, (n,), "norms"),
            (c.w, f32, (n,), "w"), (c.xw, f32, (S,), "xw"), (c.idcs, i32, (K,), "idcs"),
            (c.size, i32, (), "size"), (c.itr, i32, (), "itr"), (c.itr_end, i32, (), "itr_end"),
            (c.fail, i32, (), "fail"), (c.done, b8, (), "done"), (c.bxw, f32, (), "bxw"),
            (c.nw2, f32, (), "nw2"), (c.err, f32, (), "err"), (c.wscale, f32, (), "wscale"),
            (work.dirs, f32, (S, 2), "work.dirs"), (work.f, i32, (1,), "work.f"),
            (work.score, f32, (1,), "work.score"), (work.commit, b8, (), "work.commit"),
            (work.fold, b8, (), "work.fold"), (work.ws2, f32, (), "work.ws2"),
            (work.raw, f32, (), "work.raw")]:
        _need(t, dtype, shape, name, dev)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class Step:
    """The fused iterations of one carry, made once per segment (and again
    after a refresh, which makes new ``xw`` and cache tensors): ``consts``,
    the carry ``c`` and the new :class:`Work` are checked once, the kernels'
    arguments made once (the object keeps every tensor they point to), and
    the first directions computed.  Each :meth:`iterate` is then the
    select, the update kernel, the fold and the finish, with nothing
    allocated.  On CPU tensors the same calls run the plain versions."""

    def __init__(self, consts, c, tol: float):
        self.consts, self.c, self.tol = consts, c, tol
        self.work = w = work(c.xw)
        _check(consts, c, w)
        V = consts.V
        self.card = V.device.type == "cuda"
        if not self.card and V.device.type != "cpu":
            raise ValueError(f"the fused step runs on CPU or CUDA tensors, not {V.device}")
        if self.card:
            p = _ptr
            S = c.xw.shape[0]
            head = (p(consts.b), consts.b.stride(0), p(consts.bnorm), p(c.xw), p(c.bxw),
                    p(c.nw2), S, p(w.dirs))
            self._dirs = head + (None,) * 4
            self._finish = head + (p(c.w), p(w.f), p(w.commit), p(w.raw))
            self._update = (
                p(V), int(V.dtype == torch.int8), V.stride(0), p(consts.norms), p(consts.b),
                consts.b.stride(0), p(consts.bnorm), S, c.idcs.shape[0], p(w.f), p(c.w),
                p(c.xw), p(c.idcs), p(c.size), p(c.itr), p(c.itr_end), p(c.fail), p(c.done),
                p(c.bxw), p(c.nw2), p(c.err), p(c.wscale), ctypes.c_float(np.float32(tol)),
                ctypes.c_float(np.float32(1.0 + tol)), ctypes.c_float(np.float32(WSCALE_FLOOR)),
                p(w.commit), p(w.fold), p(w.ws2), p(w.raw))
            self.lib = _cuda_build.load_library()
        self.directions()

    def _launch(self, fn, args, what: str) -> None:
        dev = self.consts.V.device
        with torch.cuda.device(dev):
            err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"giga_step {what} launch failed: CUDA error {err}")

    def directions(self) -> None:
        """The select's directions [cdir_n, xw_n] of the carry into
        ``work.dirs``: one launch, or :func:`directions_ref`."""
        global dirs_launches
        if not self.card:
            return directions_ref(self.consts, self.c, self.work)
        self._launch(self.lib.giga_step_dirs_launch, self._dirs, "directions")
        dirs_launches += 1

    def update(self) -> None:
        """One GIGA step from the select's index ``work.f``: the carry is
        committed in place where the step commits and ``live`` holds, and
        the work gets the weight write and ``fold_scale``'s flag and scale.
        One launch, or :func:`update_ref`."""
        global launches
        if not self.card:
            return update_ref(self.consts, self.c, self.tol, self.work)
        self._launch(self.lib.giga_step_update_launch, self._update, "update")
        launches += 1

    def finish(self) -> None:
        """The step's weight write ``w[f] = raw`` where it committed (after
        ``fold_scale``), then the directions of the new carry: one launch,
        or :func:`finish_ref`."""
        global dirs_launches
        if not self.card:
            return finish_ref(self.consts, self.c, self.work)
        self._launch(self.lib.giga_step_dirs_launch, self._finish, "finish")
        dirs_launches += 1

    def iterate(self) -> None:
        """One iteration: four launches on a CUDA device."""
        k, w = self.consts, self.work
        gs.giga_select_into(k.Vsel, w.dirs, k.norms, k.valid, w.f, w.score)
        self.update()
        fold_scale(self.c.w, w.fold, w.ws2)
        self.finish()
