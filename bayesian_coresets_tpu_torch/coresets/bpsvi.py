"""Batch pseudocoreset variational inference (BatchPSVI).

Port of ``bayesian_coresets_tpu/coresets/bpsvi.py`` (reference
``bayesiancoresets/coreset/bpsvi.py:6-63``): initialize ``sz`` synthetic
pseudo-points by uniform subsampling with weights N/sz, then optimize
weights and point locations JOINTLY by projected Adam, where every
gradient step refits the sampler, redraws S posterior samples, and
evaluates log-likelihood and datapoint-gradient projections.  The
(sz, S, d) contraction ``ugrad = -(w ⊙ pgrads ⊙ resid).sum(samples) / S``
(reference bpsvi.py:53) is one ``torch.einsum``.  Nonnegativity holds on
the weight block only (reference nn_idcs = arange(sz), bpsvi.py:58).

The joint optimization is ``ops.opt.nn_opt``'s segments of Adam steps,
which read nothing back to the host; on a CUDA device without a mesh they
replay CUDA graphs (``graphs=None``, the default; ``graphs=False`` runs the
same steps directly, bit for bit), one set per (data, family, generator,
size, ``opt_itrs``, ``n_subsample_opt``), cached on the data tensor.  The
initial rows (:func:`uniform_init_idcs`) are drawn outside the graphs.
Draws come from a ``torch.Generator`` on the data's device.

``mesh=`` shards the data rows over the mesh's data axis, as SparseVI's
does (:mod:`.sparsevi`): each Adam step sums the rank's own rows' feature
vectors and exchanges the (S,) sum once, and the initial points come from
their owners in one (sz, d) exchange per build.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.opt import nn_opt
from ..utils import config
from .coreset import Coreset
from .projector import TangentFamily
from .sparsevi import _data_vecs, _gather_pts, _graphs, _vec_sum, data_block, resolve_family


def uniform_init_idcs(n: int, sz: int, gen: torch.Generator) -> torch.Tensor:
    """``sz`` distinct rows of ``n``, uniformly (the reference's
    ``np.random.choice(..., replace=False)``, bpsvi.py:17-20), drawn from
    ``gen`` on its device.  The JAX package draws them with NumPy seeded
    from the last word of its key instead (ROADMAP Queue 3 (b)), so the two
    packages draw different rows from the same seed."""
    return torch.randperm(int(n), generator=gen, device=gen.device)[: int(sz)]


def _subsample_sum(data, family, ctx, gen, n_sub, comm=None):
    """(the sum of the (sub)sample's feature vectors over every rank's rows,
    its scale)."""
    vecs, scale, _, _ = _data_vecs(data, family, ctx, gen, n_sub, comm)
    return _vec_sum(vecs, comm), scale, vecs.shape[1]


def bpsvi_build(data, init_idcs, gen, *, family: TangentFamily, n_sub_opt,
                opt_itrs: int, step_sched, comm=None, graphs=None, segment=None):
    """Optimize a size-``len(init_idcs)`` pseudocoreset initialized at the
    given data rows (see :func:`uniform_init_idcs`); returns (wts, pts).
    ``comm``: the data axis's exchanges, ``data`` this rank's block.
    ``graphs``, ``segment``: the Adam steps' (see ``ops.opt.nn_opt``;
    sharded runs are direct)."""
    d = data.shape[1]
    n = data.shape[0] if comm is None else comm.n
    sz = init_idcs.shape[0]
    pts0 = _gather_pts(data, init_idcs.to(data.device), comm)
    wts0 = torch.full((sz,), n / sz, dtype=data.dtype, device=data.device)
    x0 = torch.cat([wts0, pts0.reshape(-1)])
    nn_mask = torch.arange(sz * (1 + d), device=data.device) < sz   # clamp weights only

    def grad_fn(x, g, carry):
        w = x[:sz]
        u = x[sz:].reshape(sz, d)
        if family.make_ctx_warm is not None:
            ctx, carry = family.make_ctx_warm(g, w, u, carry)
        else:
            ctx = family.make_ctx(g, w, u)
        total, scale, S = _subsample_sum(data, family, ctx, g, n_sub_opt, comm)
        corevecs = family.project(ctx, u)                           # (sz, S)
        pgrads = family.project_grad(ctx, u)                        # (sz, S, d)
        inv_s = -1.0 / S
        resid = scale * total - w @ corevecs                        # (S,)
        wgrad = (corevecs @ resid) * inv_s
        ugrad = torch.einsum("m,msd,s->md", w, pgrads, resid) * inv_s
        return torch.cat([wgrad, ugrad.reshape(-1)]), carry

    # cold families thread an empty carry, as SparseVI's do
    carry0 = (family.init_carry(wts0, pts0) if family.make_ctx_warm is not None
              else torch.zeros((0,), dtype=data.dtype, device=data.device))
    xf, _ = nn_opt(x0, grad_fn, gen, nn_mask=nn_mask, opt_itrs=opt_itrs,
                   step_sched=step_sched, aux0=carry0, graphs=_graphs(graphs, comm),
                   segment=segment, cache=((data,), ("bpsvi", family, n_sub_opt)))
    return xf[:sz], xf[sz:].reshape(sz, d)


def bpsvi_error(data, wts, pts, gen, *, family: TangentFamily, n_sub, comm=None):
    """Monte Carlo estimate of the Hilbert residual norm
    ||sum_i ell_i - sum_m w_m ell_m|| / sqrt(S) under the current
    pseudocoreset posterior (the reference's error() is an unimplemented
    0, bpsvi.py:62-63)."""
    ctx = family.make_ctx(gen, wts, pts)
    total, scale, _ = _subsample_sum(data, family, ctx, gen, n_sub, comm)
    resid = scale * total - wts @ family.project(ctx, pts)
    return torch.sqrt(torch.mean(resid * resid))


class BatchPSVICoreset(Coreset):
    """Stateful facade with the reference's API (bpsvi.py:7-13).

    As in the reference, ``build(sz)``'s argument is the pseudocoreset
    SIZE, not an iteration count, and each call re-initializes.  The data
    lives on its device (a tensor's own, else ``device``, else the default
    device) and so does the generator, seeded with ``seed``.  ``mesh``
    (``parallel.make_mesh``) shards the data rows over its data axis: every
    rank passes the same data, keeps its block, and calls every method.
    ``graphs`` and ``segment`` go to the Adam steps (``ops.opt.nn_opt``:
    by default replayed CUDA graphs on a CUDA device without a mesh).
    """

    comm = None

    def __init__(self, data, ll_projector, opt_itrs: int, n_subsample_opt=None,
                 step_sched=lambda i: 1.0 / (1.0 + i), seed: int = 0, device=None,
                 mesh=None, graphs: bool | None = None, segment: int | None = None):
        super().__init__()
        self.graphs, self.segment = graphs, segment
        self.data = config.as_tensor(data, config.default_dtype(), device)
        self.family = resolve_family(ll_projector)
        if self.family.project_grad is None:
            raise ValueError("BatchPSVICoreset requires a grad_loglikelihood "
                             "(reference projector.py:23-24)")
        n = self.n = self.data.shape[0]
        if mesh is not None:
            self.data, self.comm = data_block(self.data, mesh)
        self.opt_itrs = int(opt_itrs)
        self.n_subsample_opt = None if n_subsample_opt is None else min(n, int(n_subsample_opt))
        self.step_sched = step_sched
        self._seed = seed
        self._gen = torch.Generator(device=self.data.device).manual_seed(seed)

    def reset(self):
        self._gen.manual_seed(self._seed)
        super().reset()

    def _build(self, sz: int):
        init_idcs = uniform_init_idcs(self.n, int(sz), self._gen)
        wts, pts = bpsvi_build(
            self.data, init_idcs, self._gen, family=self.family,
            n_sub_opt=self.n_subsample_opt, opt_itrs=self.opt_itrs,
            step_sched=self.step_sched, comm=self.comm, graphs=self.graphs,
            segment=self.segment)
        self.wts = wts.cpu().numpy()
        self.pts = pts.cpu().numpy()
        self.idcs = -1 * np.ones(int(sz), dtype=np.int64)   # synthetic points

    def _optimize(self):
        pass  # the joint optimization already runs inside _build (bpsvi.py:21-22)

    def error(self) -> float:
        """Monte Carlo estimate of the Hilbert residual norm (see
        bpsvi_error); 0.0 for an empty pseudocoreset."""
        if np.size(self.wts) == 0:
            return 0.0
        dt, dev = self.data.dtype, self.data.device
        return float(bpsvi_error(
            self.data, torch.as_tensor(self.wts, dtype=dt, device=dev),
            torch.as_tensor(self.pts, dtype=dt, device=dev), self._gen,
            family=self.family, n_sub=self.n_subsample_opt, comm=self.comm))
