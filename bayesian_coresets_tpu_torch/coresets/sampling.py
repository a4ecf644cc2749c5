"""Uniform-sampling baseline coreset.

Port of ``bayesian_coresets_tpu/coresets/sampling.py`` (reference
``bayesiancoresets/coreset/sampling.py:5-27``): draw ``itrs`` uniform
indices with replacement, count multiplicities, and weight each distinct
point N * count / total_count.  It is trivially cheap, so it runs on the
host with a per-instance NumPy generator; a tensor on any device is copied
to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from .coreset import Coreset


class UniformSamplingCoreset(Coreset):
    def __init__(self, data, seed: int = 0):
        super().__init__()
        self.data = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
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
        self.pts = self.data[idcs]

    def _optimize(self):
        pass

    def error(self) -> float:
        return 0.0
