"""Coreset base class: lifecycle state machine shared by all builders.

Port of ``bayesian_coresets_tpu/coresets/coreset.py`` (reference
``bayesiancoresets/coreset/coreset.py:7-70``): holds (wts, idcs, pts) as
host numpy arrays, a ``reached_numeric_limit`` latch, guarded ``build``,
``optimize`` with error-monotonicity rollback, and ``get()`` filtered to
strictly positive weights.
"""

from __future__ import annotations

import numpy as np

from ..utils import config
from ..utils.errors import NumericalPrecisionError
from ..utils.log import get_logger


class Coreset:
    def __init__(self):
        self.log = get_logger(self)
        self.reached_numeric_limit = False
        self.wts = np.array([])
        self.idcs = np.array([], dtype=np.int64)
        self.pts = np.array([])

    def reset(self):
        self.wts = np.array([])
        self.idcs = np.array([], dtype=np.int64)
        self.pts = np.array([])
        self.reached_numeric_limit = False

    def size(self) -> int:
        return int((self.wts > 0).sum())

    def get(self):
        """(wts, pts, idcs) restricted to strictly positive weights
        (reference coreset.py:25-28)."""
        if self.wts.shape[0] == 0:
            return np.array([]), np.array([]), np.array([])
        keep = self.wts > 0
        return self.wts[keep], self.pts[keep, :], self.idcs[keep]

    def error(self) -> float:
        raise NotImplementedError

    def build(self, itrs: int):
        """Guarded incremental build (reference coreset.py:33-44)."""
        if self.reached_numeric_limit or itrs <= 0:
            return
        self._build(itrs)
        if self.reached_numeric_limit:
            self.log.warning(
                "the numeric limit has been reached. No more points will be "
                f"added. size = {self.size()}, error = {self.error()}")

    def optimize(self):
        """Weight re-optimization with rollback (reference coreset.py:47-64)."""
        prev_cost = self.error()
        old = (self.wts.copy(), self.idcs.copy(), self.pts.copy())
        try:
            self._optimize()
            new_cost = self.error()
            if new_cost > prev_cost * (1.0 + config.TOL):
                raise NumericalPrecisionError(
                    f"optimize() increased error: prev = {prev_cost}, new = {new_cost}")
        except NumericalPrecisionError as e:
            self.log.warning(str(e))
            self.wts, self.idcs, self.pts = old
            self.reached_numeric_limit = True

    def _build(self, itrs: int):
        raise NotImplementedError

    def _optimize(self):
        raise NotImplementedError
