"""Uniform-sampling baseline coreset.

Port of ``bayesian_coresets_tpu/coresets/sampling.py`` (reference
``bayesiancoresets/coreset/sampling.py:5-27``): draw ``itrs`` uniform
indices with replacement, count multiplicities, and weight each distinct
point N * count / total_count.  The data lives on its device (a tensor's
own, else ``device``, else the default device) and the points are gathered
there.  The indices are drawn as the JAX package draws them, on the host
from a per-instance NumPy generator seeded with ``seed``, so both packages
pick the same points: the draw is a few integers, not device work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import config
from .coreset import Coreset


class UniformSamplingCoreset(Coreset):
    def __init__(self, data, seed: int = 0, device=None):
        super().__init__()
        self.data = config.as_tensor(data, device=device)
        self.rng = np.random.default_rng(seed)
        self.cts: dict[int, int] = {}
        self._seed = seed

    def reset(self):
        self.cts = {}
        self.rng = np.random.default_rng(self._seed)
        super().reset()

    def _build(self, itrs: int):
        draws = self.rng.integers(0, self.data.shape[0], size=itrs)
        for f in draws:
            self.cts[int(f)] = self.cts.get(int(f), 0) + 1
        idcs = np.fromiter(self.cts.keys(), dtype=np.int64, count=len(self.cts))
        cts = np.fromiter(self.cts.values(), dtype=np.float64, count=len(self.cts))
        self.wts = self.data.shape[0] * cts / cts.sum()
        self.idcs = idcs
        self.pts = self.data[torch.as_tensor(idcs, device=self.data.device)].cpu().numpy()

    def _optimize(self):
        pass

    def error(self) -> float:
        return 0.0
