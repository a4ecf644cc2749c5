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

Where the JAX package runs ``lax.while_loop`` over ``lax.scan``, the
selects are a Python loop here and each select's Adam steps are
``ops.opt.nn_opt``'s segments.  ``size`` is a host integer between the
selects: each select reads one flag back (whether a point was added; the
slot write itself stays on the device).  The Adam steps read nothing: they
take ``size`` as a device value (``arange(capacity) < size``) and the slots'
points from a device tensor, so on a CUDA device without a mesh they
replay CUDA graphs (``graphs=None``, the default; ``graphs=False`` runs the
same steps directly, bit for bit) and one set of graphs serves every
select of a build, and every build on the same (data, family, generator,
capacity, ``opt_itrs``, ``n_subsample_opt``), cached on the data tensor.
A family whose context refit reads the host cannot be captured (the
capture raises): pass ``graphs=False`` for it.  None of the package's
families is such a one (the linear-regression exact family's low-rank
refit takes a matrix square root by Cholesky factors, not an ``eigh``).
Draws come from a
``torch.Generator`` on the data's device (``gen`` below), which every
context rebuild and subsample advances.
Nothing divides by a Python scalar (CUDA would multiply by its reciprocal,
the CPU does not), so card and CPU builds round alike.

``mesh=`` (``parallel.make_mesh``) shards the data rows over the mesh's
data axis, as the JAX package runs these cores on row-sharded data with
the collectives XLA inserts (tests/test_parallel.py:218-268 there).  Every
rank passes the global data and keeps its contiguous block of rows
(``parallel/coreset.py``'s ``row_block``); the cores take the data axis's
:class:`..parallel.comm.Comm` (``comm=``), with ``comm.n`` the global row
count.  Every rank's generator is seeded alike, so the contexts, the
subsample draws and the Adam steps agree.  What the data axis changes:

- sums over the data rows are each rank's partial sum of its own rows'
  feature vectors plus one exchange of the (S,) vector per context rebuild;
- with a subsample, each rank projects only the drawn rows it owns (a
  host read of their count);
- the greedy select takes each rank's best correlation over its rows, then
  the largest over the ranks, ties to the first position in the draw list
  (or the lowest row), as one process's argmax takes it;
- the coreset's points ``data[idcs]`` come from their owners in one (K, d)
  exchange per select, not per Adam step.

The rest (the context refit, the core points' features, ``nn_opt``) is
replicated.  The results are the single-process build's up to the order of
the sums over rows.
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


def _gather_pts(data: torch.Tensor, idcs: torch.Tensor, comm=None) -> torch.Tensor:
    """Rows ``data[idcs]`` (an empty slot's -1 reads row 0); sharded,
    ``data`` is this rank's block and the rows come from their owners in
    one (K, d) exchange."""
    if comm is None:
        return data.index_select(0, torch.clamp(idcs, 0, data.shape[0] - 1))
    j, mine = comm.local(torch.clamp(idcs, 0, comm.n - 1), data.shape[0])
    return comm.owned(data.index_select(0, j), mine, "points")


def data_block(data: torch.Tensor, mesh):
    """(this rank's block of ``data``'s rows, the data axis's exchanges)
    for ``mesh`` (``parallel.make_mesh``): the rows of
    ``parallel.coreset.row_block``, unpadded."""
    from ..parallel.comm import Comm
    from ..parallel.coreset import row_block
    from ..parallel.mesh import DATA_AXIS, Mesh

    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must come from parallel.make_mesh; got {type(mesh).__name__}")
    n = data.shape[0]
    lo, per = row_block(n, mesh)
    if lo >= n:
        raise ValueError(f"{n} rows leave the data axis's rank {mesh.axis_index(DATA_AXIS)} "
                         "without any: use fewer ranks")
    return data[lo:lo + per].clone(), Comm(mesh, DATA_AXIS, per, n)


def _data_vecs(data, family: TangentFamily, ctx, gen, n_sub, comm=None):
    """Feature vectors of the data's rows, or of ``n_sub`` rows drawn with
    replacement: (vecs, scale, the draws (None without a subsample), the
    global position of each vec).  Sharded, ``vecs`` are this rank's rows
    only and the positions are their global rows, or their places in the
    draw list (one process: positions None, vecs in that order)."""
    n = data.shape[0] if comm is None else comm.n
    if n_sub is None:
        vecs = family.project(ctx, data)
        pos = None if comm is None else comm.lo + torch.arange(data.shape[0],
                                                               device=data.device)
        return vecs, 1.0, None, pos
    sub = torch.randint(0, n, (n_sub,), generator=gen, device=gen.device).to(data.device)
    if comm is None:
        return family.project(ctx, data.index_select(0, sub)), n / n_sub, sub, None
    j, mine = comm.local(sub, data.shape[0])
    pos = torch.nonzero(mine).view(-1)
    return family.project(ctx, data.index_select(0, j.index_select(0, pos))), n / n_sub, sub, pos


def _vec_sum(vecs: torch.Tensor, comm=None) -> torch.Tensor:
    """The sum of the feature vectors over the data rows (sharded: every
    rank's, one (S,) exchange)."""
    total = torch.sum(vecs, dim=0)
    return total if comm is None else comm.all_reduce(total, "sum")


def _slot_mask(wts: torch.Tensor, size) -> torch.Tensor:
    """The filled slots: ``size`` a host integer or a 0-dim device tensor."""
    return torch.arange(wts.shape[0], device=wts.device) < size


def _init_carry(data, family: TangentFamily, wts, pts, size: int):
    """Carried context state at build entry: fully converged for the current
    coreset (see TangentFamily.init_carry); an empty dummy for cold families.
    ``pts`` are the slots' points (:func:`_gather_pts`)."""
    if family.init_carry is None:
        return torch.zeros((0,), dtype=data.dtype, device=data.device)
    mask = _slot_mask(wts, size)
    return family.init_carry(torch.where(mask, wts, 0.0), pts)


def _projections(data, family: TangentFamily, gen, w, pts, size, n_sub,
                 carry, grad: bool = False, comm=None):
    """Reference _get_projection (sparsevi.py:23-42): rebuild the context,
    project a (sub)sample of the data (:func:`_data_vecs`) and the current
    coreset points ``pts``."""
    mask = _slot_mask(w, size)
    wm = torch.where(mask, w, 0.0)
    if family.make_ctx_warm is not None:
        ctx, carry = family.make_ctx_warm(gen, wm, pts, carry)
    else:
        ctx = family.make_ctx(gen, wm, pts)
    vecs, scale, sub_idcs, pos = _data_vecs(data, family, ctx, gen, n_sub, comm)
    corevecs = family.project(ctx, pts)
    pgrads = family.project_grad(ctx, pts) if grad else None
    return vecs, scale, sub_idcs, pos, corevecs, pgrads, mask, carry


def _select(data, family, gen, wts, idcs, pts, size: int, n_sub_sel, carry, comm=None):
    """Greedy residual-correlation selection (reference sparsevi.py:44-67).

    The one host read of a build iteration: whether a point was added."""
    vecs, scale, sub_idcs, pos, corevecs, _, mask, carry = _projections(
        data, family, gen, wts, pts, size, n_sub_sel, carry, comm=comm)
    S = vecs.shape[1]
    resid = scale * _vec_sum(vecs, comm) - torch.where(mask, wts, 0.0) @ corevecs

    vnorm = torch.sqrt(torch.sum(vecs * vecs, dim=1))
    corrs = torch.where(vnorm > 0,
                        (vecs @ resid) / (torch.where(vnorm > 0, vnorm, 1.0) * S),
                        -torch.inf)
    cnorm = torch.sqrt(torch.sum(corevecs * corevecs, dim=1))
    corecorrs = torch.where(mask & (cnorm > 0),
                            torch.abs(corevecs @ resid) / (torch.where(cnorm > 0, cnorm, 1.0) * S),
                            -torch.inf)
    if comm is None:
        f = torch.argmax(corrs, dim=0, keepdim=True)
        best = torch.max(corrs)
    else:           # each rank's first maximum, then the ranks' by position
        if corrs.shape[0]:
            k = torch.argmax(corrs)
            local = (pos[k], corrs[k])
        else:
            local = (torch.tensor(comm.n if sub_idcs is None else sub_idcs.shape[0],
                                  device=corrs.device),
                     torch.tensor(-torch.inf, dtype=corrs.dtype, device=corrs.device))
        f, best = comm.first_max(*local)
        f = f.view(1)
    if sub_idcs is not None:
        f = sub_idcs.index_select(0, f)
    take_new = (best > torch.max(corecorrs)) | (size == 0)
    present = torch.any(mask & (idcs == f))               # sparsevi.py:59 dedup
    add = take_new & ~present
    # the slot write stays on the device; past capacity no slot matches
    slot = (torch.arange(wts.shape[0], device=wts.device) == size) & add
    idcs = torch.where(slot, f, idcs)
    wts = torch.where(slot, 0.0, wts)
    if size < wts.shape[0] and bool(add):
        size += 1
    return wts, idcs, size, carry


def _adam_grad(data, family, n_sub_opt, comm=None):
    """The Adam step's gradient ``(w, gen, carry, (pts, size)) -> (grad,
    carry)``: the slots' points and the slot count come in as device
    values, as the JAX package's traced ``size`` (sparsevi.py:120 there)."""

    def grad_fn(w, g, carry, inputs):
        pts, size = inputs
        vecs, scale, _, _, corevecs, _, mask, carry = _projections(
            data, family, g, w, pts, size, n_sub_opt, carry, comm=comm)
        resid = scale * _vec_sum(vecs, comm) - torch.where(mask, w, 0.0) @ corevecs
        grad = (corevecs @ resid) * (-1.0 / vecs.shape[1])
        return torch.where(mask, grad, 0.0), carry

    return grad_fn


def _graphs(graphs, comm):
    """Whether the Adam steps may replay graphs: never when sharded (a
    collective of gloo cannot be captured)."""
    if comm is None:
        return graphs
    if graphs:
        raise ValueError("sharded SparseVI and BatchPSVI run their Adam steps directly; "
                         "pass graphs=None or False with a mesh")
    return False


def _optimize(data, family, gen, wts, pts, size: int, n_sub_opt, opt_itrs,
              step_sched, carry, comm=None, graphs=None, segment=None):
    """Re-solve all active weights; each Adam step rebuilds the context
    (reference sparsevi.py:69-76), warm-starting from the carried state.
    The steps read the points and the slot count from device tensors, so
    on a CUDA device without ``comm`` one set of replayed graphs
    (``nn_opt``'s, cached on ``data``) serves every optimize with the same
    (family, generator, capacity, ``opt_itrs``, ``n_sub_opt``)."""
    size_t = torch.full((), int(size), dtype=torch.int64, device=wts.device)
    w, carry = nn_opt(wts, _adam_grad(data, family, n_sub_opt, comm), gen, nn_mask=None,
                      opt_itrs=opt_itrs, step_sched=step_sched, aux0=carry,
                      inputs=(pts, size_t), graphs=_graphs(graphs, comm), segment=segment,
                      cache=((data,), ("svi", family, n_sub_opt)))
    return torch.where(_slot_mask(wts, size), w, 0.0), carry


def svi_build(data, wts, idcs, size: int, gen, itrs: int, *, family: TangentFamily,
              n_sub_sel, n_sub_opt, opt_itrs: int, step_sched, comm=None,
              graphs=None, segment=None):
    """Run ``itrs`` select+optimize rounds; returns (wts, idcs, size).
    ``comm``: the data axis's exchanges, ``data`` this rank's block (see
    the module's notes).  ``graphs``, ``segment``: the Adam steps' (see
    ``ops.opt.nn_opt``; sharded runs are direct)."""
    pts = _gather_pts(data, idcs, comm)
    carry = _init_carry(data, family, wts, pts, size)
    for _ in range(int(itrs)):
        wts, idcs, size, carry = _select(data, family, gen, wts, idcs, pts, size,
                                         n_sub_sel, carry, comm)
        pts = _gather_pts(data, idcs, comm)
        wts, carry = _optimize(data, family, gen, wts, pts, size, n_sub_opt,
                               opt_itrs, step_sched, carry, comm, graphs, segment)
    return wts, idcs, size


def svi_optimize(data, wts, idcs, size: int, gen, *, family, n_sub_opt,
                 opt_itrs, step_sched, comm=None, graphs=None, segment=None):
    pts = _gather_pts(data, idcs, comm)
    carry = _init_carry(data, family, wts, pts, size)
    wts, _ = _optimize(data, family, gen, wts, pts, size, n_sub_opt, opt_itrs,
                       step_sched, carry, comm, graphs, segment)
    return wts


def _rms(resid: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(resid * resid))


def svi_error_pair(data, w_old, w_new, idcs, size: int, gen, *, family, n_sub, comm=None):
    """(error(w_old), error(w_new)) under ONE shared context built from
    ``w_old`` (common random numbers): both residual norms live in the same
    tangent space with the same Monte Carlo samples, so their difference
    reflects the weight change alone, not the measure's dependence on the
    weights."""
    pts = _gather_pts(data, idcs, comm)
    carry = _init_carry(data, family, w_old, pts, size)
    vecs, scale, _, _, corevecs, _, mask, _ = _projections(
        data, family, gen, w_old, pts, size, n_sub, carry, comm=comm)
    base = scale * _vec_sum(vecs, comm)
    return tuple(_rms(base - torch.where(mask, w, 0.0) @ corevecs) for w in (w_old, w_new))


def svi_error(data, wts, idcs, size: int, gen, *, family, n_sub, comm=None):
    """Monte Carlo estimate of the Hilbert residual norm
    ||sum_i ell_i - sum_m w_m ell_m|| / sqrt(S) under the current coreset
    posterior (the reference's error() is an unimplemented 0,
    sparsevi.py:78)."""
    pts = _gather_pts(data, idcs, comm)
    carry = _init_carry(data, family, wts, pts, size)
    vecs, scale, _, _, corevecs, _, mask, _ = _projections(
        data, family, gen, wts, pts, size, n_sub, carry, comm=comm)
    return _rms(scale * _vec_sum(vecs, comm) - torch.where(mask, wts, 0.0) @ corevecs)


class SparseVICoreset(Coreset):
    """Stateful facade with the reference's API (sparsevi.py:7-14).

    The data stays on its device (a tensor's own, else ``device``, else the
    default device), and so do the slot arrays and the generator (seeded
    with ``seed``); ``reset()`` reseeds it, so the same builds after a
    reset give the same coreset.  ``capacity`` preallocates
    the slots (they double on demand otherwise).

    ``mesh`` (``parallel.make_mesh``) shards the data rows over its data
    axis (see the module's notes): every rank passes the same data, keeps
    its block, and calls every method (they are collective).  ``graphs``
    and ``segment`` go to the Adam steps (``ops.opt.nn_opt``: by default
    replayed CUDA graphs on a CUDA device without a mesh).
    """

    comm = None

    def __init__(self, data, ll_projector, n_subsample_select=None,
                 n_subsample_opt=None, opt_itrs: int = 100,
                 step_sched=lambda i: 1.0 / (1.0 + i), seed: int = 0,
                 capacity: int | None = None, device=None, mesh=None,
                 graphs: bool | None = None, segment: int | None = None):
        super().__init__()
        self.graphs, self.segment = graphs, segment
        self.data = config.as_tensor(data, config.default_dtype(), device)
        n = self.data.shape[0]
        if mesh is not None:
            self.data, self.comm = data_block(self.data, mesh)
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
        self.pts = (_gather_pts(self.data, self._idcs[:sz], self.comm).cpu().numpy() if sz
                    else np.array([]))

    def _build(self, itrs: int):
        self._ensure_capacity(itrs)
        self._wts, self._idcs, self._size = svi_build(
            self.data, self._wts, self._idcs, self._size, self._gen, itrs,
            family=self.family, n_sub_sel=self.n_subsample_select,
            n_sub_opt=self.n_subsample_opt, opt_itrs=self.opt_itrs,
            step_sched=self.step_sched, comm=self.comm, graphs=self.graphs,
            segment=self.segment)
        self._sync()

    def _optimize(self):
        self._wts = svi_optimize(
            self.data, self._wts, self._idcs, self._size, self._gen,
            family=self.family, n_sub_opt=self.n_subsample_opt,
            opt_itrs=self.opt_itrs, step_sched=self.step_sched, comm=self.comm,
            graphs=self.graphs, segment=self.segment)
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
            family=self.family, n_sub=self.n_subsample_opt, comm=self.comm))
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
                               family=self.family, n_sub=self.n_subsample_opt, comm=self.comm))
