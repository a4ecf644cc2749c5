"""Hilbert-norm coresets: projection + sparse NNLS.

Port of the in-memory path of ``bayesian_coresets_tpu/coresets/hilbert.py``
(reference ``bayesiancoresets/coreset/hilbert.py:6-48``): discretize
log-likelihoods into per-datum feature vectors, form the system
A = vecs.T, b = sum of valid vecs, and hand it to GIGA.  Weights map back
through the (optional) subsample indices.

The projection, the system and the solver stay on the data's device.  The
subsample keeps a fixed shape: the reference's
``np.unique(np.random.randint(...))`` (hilbert.py:16) shrinks the array,
so here duplicate and zero-vector rows are masked ``valid=False`` instead.
Streamed int8-resident and mesh-sharded construction are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.snnls import GIGA
from .coreset import Coreset
from .projector import Projector


class HilbertCoreset(Coreset):
    def __init__(self, data: torch.Tensor, ll_projector: Projector,
                 n_subsample: int | None = None, snnls=GIGA, seed: int = 0,
                 max_active: int | None = None, select_dtype=None):
        super().__init__()
        data = torch.as_tensor(data)
        if n_subsample is None:
            sub_idcs = np.arange(data.shape[0])
            vecs = ll_projector.project(data)
            valid = torch.ones(data.shape[0], dtype=torch.bool, device=vecs.device)
        else:
            # reference sampling distribution (randint-with-replacement then
            # dedup, hilbert.py:16) at a fixed shape via masking
            rng = np.random.default_rng(seed)
            sub_idcs = rng.integers(0, data.shape[0], size=n_subsample)
            uniq = np.zeros(n_subsample, dtype=bool)
            uniq[np.unique(sub_idcs, return_index=True)[1]] = True
            vecs = ll_projector.project(data[torch.as_tensor(sub_idcs, device=data.device)])
            valid = torch.as_tensor(uniq, device=vecs.device)
        # mask zero vectors instead of pruning (hilbert.py:20-22)
        valid = valid & (torch.sqrt(torch.sum(vecs**2, dim=1)) > 0.0)
        if not bool(valid.any()):
            raise ValueError("all projected vectors are zero or masked")
        b = vecs[valid].sum(dim=0)
        self.snnls = snnls(vecs.T, b, valid=valid, seed=seed,
                           max_active=max_active, select_dtype=select_dtype)
        self.sub_idcs = sub_idcs
        self.data = data

    def reset(self):
        self.snnls.reset()
        super().reset()

    def _sync(self):
        # active-set extraction on the device: O(max_active) values cross
        # to the host instead of the (n,) weight vector
        idx, vals = self.snnls.active()
        keep = (idx >= 0) & (idx < len(self.sub_idcs))
        idx, vals = idx[keep], vals[keep]
        order = np.argsort(idx)            # stable order by solver column
        self.wts = vals[order]
        self.idcs = self.sub_idcs[idx[order]]
        self.pts = self.data[torch.as_tensor(self.idcs, device=self.data.device)].cpu().numpy()
        self.reached_numeric_limit = self.snnls.reached_numeric_limit

    def _build(self, itrs: int):
        self.snnls.build(itrs)
        self._sync()

    def error(self) -> float:
        return self.snnls.error()
