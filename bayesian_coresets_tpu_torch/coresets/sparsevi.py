"""SparseVI: greedy KL-minimizing coresets with Monte Carlo gradients.

Port of ``bayesian_coresets_tpu/coresets/sparsevi.py`` (reference
``bayesiancoresets/coreset/sparsevi.py:6-79``).  Each build iteration
(i) rebuilds the projection context from the current coreset (posterior
refit and fresh samples for black-box families, closed-form factors for
exact ones) and greedily selects the datapoint whose centered feature
vector best correlates with the residual, then (ii) re-optimizes all
active weights with projected Adam, where every gradient step rebuilds the
context.  The coreset lives in fixed-capacity slot arrays (the slots past
``size`` are empty), so the shapes of every step stay fixed while the
support grows.

Where the JAX package runs ``lax.while_loop`` over ``lax.scan``, both loops
are Python loops here.  ``size`` is a host integer: each select reads one
flag back (whether a point was added; the slot write itself stays on the
device), and no Adam step reads anything.  Draws come from a
``torch.Generator`` on the data's device (``gen`` below), which every
context rebuild and subsample advances.
Nothing divides by a Python scalar (CUDA would multiply by its reciprocal,
the CPU does not), so card and CPU builds round alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.opt import nn_opt
from ..utils import checkpoint, config
from .coreset import Coreset
from .projector import FamilyProjector, TangentFamily


def resolve_family(ll_projector) -> TangentFamily:
    if isinstance(ll_projector, TangentFamily):
        return ll_projector
    if isinstance(ll_projector, FamilyProjector):
        return ll_projector.family
    raise TypeError(
        "ll_projector must be a TangentFamily or FamilyProjector/BlackBoxProjector")


def _gather_pts(data: torch.Tensor, idcs: torch.Tensor) -> torch.Tensor:
    return data.index_select(0, torch.clamp(idcs, 0, data.shape[0] - 1))


def _slot_mask(wts: torch.Tensor, size: int) -> torch.Tensor:
    return torch.arange(wts.shape[0], device=wts.device) < size


def _init_carry(data, family: TangentFamily, wts, idcs, size: int):
    """Carried context state at build entry: fully converged for the current
    coreset (see TangentFamily.init_carry); an empty dummy for cold families."""
    if family.init_carry is None:
        return torch.zeros((0,), dtype=data.dtype, device=data.device)
    mask = _slot_mask(wts, size)
    return family.init_carry(torch.where(mask, wts, 0.0), _gather_pts(data, idcs))


def _projections(data, family: TangentFamily, gen, w, idcs, size: int, n_sub,
                 carry, grad: bool = False):
    """Reference _get_projection (sparsevi.py:23-42): rebuild the context,
    project a (sub)sample of the data and the current coreset points."""
    n = data.shape[0]
    mask = _slot_mask(w, size)
    pts = _gather_pts(data, idcs)
    wm = torch.where(mask, w, 0.0)
    if family.make_ctx_warm is not None:
        ctx, carry = family.make_ctx_warm(gen, wm, pts, carry)
    else:
        ctx = family.make_ctx(gen, wm, pts)
    if n_sub is None:
        sub_idcs = None
        vecs = family.project(ctx, data)
        scale = 1.0
    else:
        sub_idcs = torch.randint(0, n, (n_sub,), generator=gen,
                                 device=gen.device).to(data.device)
        vecs = family.project(ctx, data.index_select(0, sub_idcs))
        scale = n / n_sub
    corevecs = family.project(ctx, pts)
    pgrads = family.project_grad(ctx, pts) if grad else None
    return vecs, scale, sub_idcs, corevecs, pgrads, mask, carry


def _select(data, family, gen, wts, idcs, size: int, n_sub_sel, carry):
    """Greedy residual-correlation selection (reference sparsevi.py:44-67).

    The one host read of a build iteration: whether a point was added."""
    vecs, scale, sub_idcs, corevecs, _, mask, carry = _projections(
        data, family, gen, wts, idcs, size, n_sub_sel, carry)
    S = vecs.shape[1]
    resid = scale * torch.sum(vecs, dim=0) - torch.where(mask, wts, 0.0) @ corevecs

    vnorm = torch.sqrt(torch.sum(vecs * vecs, dim=1))
    corrs = torch.where(vnorm > 0,
                        (vecs @ resid) / (torch.where(vnorm > 0, vnorm, 1.0) * S),
                        -torch.inf)
    cnorm = torch.sqrt(torch.sum(corevecs * corevecs, dim=1))
    corecorrs = torch.where(mask & (cnorm > 0),
                            torch.abs(corevecs @ resid) / (torch.where(cnorm > 0, cnorm, 1.0) * S),
                            -torch.inf)
    f = torch.argmax(corrs, dim=0, keepdim=True)
    if sub_idcs is not None:
        f = sub_idcs.index_select(0, f)
    take_new = (torch.max(corrs) > torch.max(corecorrs)) | (size == 0)
    present = torch.any(mask & (idcs == f))               # sparsevi.py:59 dedup
    add = take_new & ~present
    # the slot write stays on the device; past capacity no slot matches
    slot = (torch.arange(wts.shape[0], device=wts.device) == size) & add
    idcs = torch.where(slot, f, idcs)
    wts = torch.where(slot, 0.0, wts)
    if size < wts.shape[0] and bool(add):
        size += 1
    return wts, idcs, size, carry


def _optimize(data, family, gen, wts, idcs, size: int, n_sub_opt, opt_itrs,
              step_sched, carry):
    """Re-solve all active weights; each Adam step rebuilds the context
    (reference sparsevi.py:69-76), warm-starting from the carried state."""
    mask = _slot_mask(wts, size)

    def grad_fn(w, g, carry):
        vecs, scale, _, corevecs, _, _, carry = _projections(
            data, family, g, w, idcs, size, n_sub_opt, carry)
        resid = scale * torch.sum(vecs, dim=0) - torch.where(mask, w, 0.0) @ corevecs
        grad = (corevecs @ resid) * (-1.0 / vecs.shape[1])
        return torch.where(mask, grad, 0.0), carry

    w, carry = nn_opt(wts, grad_fn, gen, nn_mask=None, opt_itrs=opt_itrs,
                      step_sched=step_sched, aux0=carry)
    return torch.where(mask, w, 0.0), carry


def svi_build(data, wts, idcs, size: int, gen, itrs: int, *, family: TangentFamily,
              n_sub_sel, n_sub_opt, opt_itrs: int, step_sched):
    """Run ``itrs`` select+optimize rounds; returns (wts, idcs, size)."""
    carry = _init_carry(data, family, wts, idcs, size)
    for _ in range(int(itrs)):
        wts, idcs, size, carry = _select(data, family, gen, wts, idcs, size,
                                         n_sub_sel, carry)
        wts, carry = _optimize(data, family, gen, wts, idcs, size, n_sub_opt,
                               opt_itrs, step_sched, carry)
    return wts, idcs, size


def svi_optimize(data, wts, idcs, size: int, gen, *, family, n_sub_opt,
                 opt_itrs, step_sched):
    carry = _init_carry(data, family, wts, idcs, size)
    wts, _ = _optimize(data, family, gen, wts, idcs, size, n_sub_opt, opt_itrs,
                       step_sched, carry)
    return wts


def _rms(resid: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(resid * resid))


def svi_error_pair(data, w_old, w_new, idcs, size: int, gen, *, family, n_sub):
    """(error(w_old), error(w_new)) under ONE shared context built from
    ``w_old`` (common random numbers): both residual norms live in the same
    tangent space with the same Monte Carlo samples, so their difference
    reflects the weight change alone, not the measure's dependence on the
    weights."""
    carry = _init_carry(data, family, w_old, idcs, size)
    vecs, scale, _, corevecs, _, mask, _ = _projections(
        data, family, gen, w_old, idcs, size, n_sub, carry)
    base = scale * torch.sum(vecs, dim=0)
    return tuple(_rms(base - torch.where(mask, w, 0.0) @ corevecs) for w in (w_old, w_new))


def svi_error(data, wts, idcs, size: int, gen, *, family, n_sub):
    """Monte Carlo estimate of the Hilbert residual norm
    ||sum_i ell_i - sum_m w_m ell_m|| / sqrt(S) under the current coreset
    posterior (the reference's error() is an unimplemented 0,
    sparsevi.py:78)."""
    carry = _init_carry(data, family, wts, idcs, size)
    vecs, scale, _, corevecs, _, mask, _ = _projections(
        data, family, gen, wts, idcs, size, n_sub, carry)
    return _rms(scale * torch.sum(vecs, dim=0) - torch.where(mask, wts, 0.0) @ corevecs)


class SparseVICoreset(Coreset):
    """Stateful facade with the reference's API (sparsevi.py:7-14).

    The data stays on its device (a tensor's own, else ``device``, else the
    default device), and so do the slot arrays and the generator (seeded
    with ``seed``); ``reset()`` reseeds it, so the same builds after a
    reset give the same coreset.  ``capacity`` preallocates
    the slots (they double on demand otherwise).
    """

    def __init__(self, data, ll_projector, n_subsample_select=None,
                 n_subsample_opt=None, opt_itrs: int = 100,
                 step_sched=lambda i: 1.0 / (1.0 + i), seed: int = 0,
                 capacity: int | None = None, device=None):
        super().__init__()
        self.data = config.as_tensor(data, config.default_dtype(), device)
        n = self.data.shape[0]
        self.family = resolve_family(ll_projector)
        self.n_subsample_select = None if n_subsample_select is None else min(n, int(n_subsample_select))
        self.n_subsample_opt = None if n_subsample_opt is None else min(n, int(n_subsample_opt))
        self.opt_itrs = int(opt_itrs)
        self.step_sched = step_sched
        self._seed = seed
        self._init_cap = int(capacity) if capacity is not None else 0
        self._gen = torch.Generator(device=self.data.device)
        self._clear_slots()

    def _clear_slots(self):
        self._gen.manual_seed(self._seed)
        self._cap = 0
        self._wts = torch.zeros((0,), dtype=self.data.dtype, device=self.data.device)
        self._idcs = torch.full((0,), -1, dtype=torch.int64, device=self.data.device)
        self._size = 0
        if self._init_cap:
            self._ensure_capacity(self._init_cap)

    def reset(self):
        self._clear_slots()
        super().reset()

    def save(self, path: str):
        """Checkpoint (wts, idcs, size) and the generator for resume."""
        checkpoint.save(path, (self._wts, self._idcs, self._size), generator=self._gen)

    def restore(self, path: str):
        (wts, idcs, size), _ = checkpoint.load(path, generator=self._gen,
                                               device=self.data.device)
        self._wts = wts.to(self.data.dtype)
        self._idcs = idcs.to(torch.int64)
        self._size = int(size)
        self._cap = int(self._wts.shape[0])
        self._sync()

    def _ensure_capacity(self, extra: int):
        need = self._size + extra
        if need <= self._cap:
            return
        new_cap = max(8, 1 << int(np.ceil(np.log2(need))))
        wts = torch.zeros((new_cap,), dtype=self.data.dtype, device=self.data.device)
        idcs = torch.full((new_cap,), -1, dtype=torch.int64, device=self.data.device)
        wts[: self._cap] = self._wts
        idcs[: self._cap] = self._idcs
        self._wts, self._idcs, self._cap = wts, idcs, new_cap

    def _sync(self):
        sz = self._size
        self.wts = self._wts[:sz].cpu().numpy()
        self.idcs = self._idcs[:sz].cpu().numpy()
        self.pts = self.data[self._idcs[:sz]].cpu().numpy() if sz else np.array([])

    def _build(self, itrs: int):
        self._ensure_capacity(itrs)
        self._wts, self._idcs, self._size = svi_build(
            self.data, self._wts, self._idcs, self._size, self._gen, itrs,
            family=self.family, n_sub_sel=self.n_subsample_select,
            n_sub_opt=self.n_subsample_opt, opt_itrs=self.opt_itrs,
            step_sched=self.step_sched)
        self._sync()

    def _optimize(self):
        self._wts = svi_optimize(
            self.data, self._wts, self._idcs, self._size, self._gen,
            family=self.family, n_sub_opt=self.n_subsample_opt,
            opt_itrs=self.opt_itrs, step_sched=self.step_sched)
        self._sync()

    # relative slack for the CRN rollback check: with common random numbers
    # the sampling noise is shared between the before/after estimates, so
    # what remains is the small dependence of the Monte Carlo measure on the
    # updated weights; a genuine optimizer failure moves the error by far more
    _CRN_SLACK = 1e-3

    def optimize(self):
        """Weight re-optimization with a common-random-number rollback.

        Both residual norms are evaluated in one shared context built from
        the pre-optimize weights (see :func:`svi_error_pair`), with draws
        from a generator of their own, seeded by one draw taken from the
        coreset's generator before the optimize (where the JAX package
        splits ``k_err`` off its key, coresets/sparsevi.py:322).  The
        optimize starts at the same weights, so a clone of the generator
        would hand the check the draws of the optimizer's first step, which
        it has already fitted.  An optimize that raises that error beyond
        ``_CRN_SLACK`` is rolled back and latches the numeric limit.
        """
        if self._cap == 0 or self._size == 0:
            self._optimize()
            return
        dev = self._gen.device
        g_err = torch.Generator(device=dev)
        g_err.manual_seed(int(torch.randint(0, 2**62, (1,), generator=self._gen, device=dev)))
        old = (self._wts, self._idcs, self._size)
        self._optimize()
        prev_cost, new_cost = (float(v) for v in svi_error_pair(
            self.data, old[0], self._wts, self._idcs, self._size, g_err,
            family=self.family, n_sub=self.n_subsample_opt))
        if new_cost > prev_cost * (1.0 + self._CRN_SLACK + config.TOL):
            self.log.warning(
                f"optimize() increased error: prev = {prev_cost}, "
                f"new = {new_cost} (CRN estimate); rolling back")
            self._wts, self._idcs, self._size = old
            self._sync()
            self.reached_numeric_limit = True

    def error(self) -> float:
        """Monte Carlo estimate of the Hilbert residual norm (see svi_error);
        0.0 before any slot exists."""
        if self._cap == 0:
            return 0.0
        return float(svi_error(self.data, self._wts, self._idcs, self._size, self._gen,
                               family=self.family, n_sub=self.n_subsample_opt))
