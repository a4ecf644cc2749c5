"""Meshes over a ``torch.distributed`` process group.

Port of ``bayesian_coresets_tpu/parallel/mesh.py``.  There, one process
lays its devices out in a ``jax.sharding.Mesh`` and XLA inserts the
collectives.  Here one process drives one GPU (SPMD, as ``torchrun``
starts them), and a mesh names how the ranks of an initialized process
group split the work:

- ``DATA_AXIS`` shards the dataset rows (N) of a Hilbert build;
- ``CHAIN_AXIS`` shards the chains of weighted NUTS;
- ``PROJ_AXIS`` (the projection dimension S) with more than one rank is
  ROADMAP item 16b and raises ``NotImplementedError``.

A mesh shards along one axis: the others have size 1 (two-axis meshes are
item 16b too).  The mesh also owns the collective ledger
(:class:`.comm.Ledger`) that every exchange made over it records into.
"""

from __future__ import annotations

import math

import torch.distributed as dist

DATA_AXIS = "data"     # shards dataset rows (N)
PROJ_AXIS = "proj"     # shards the projection dimension (S): ROADMAP item 16b
CHAIN_AXIS = "chains"  # shards MCMC chains


class Mesh:
    """Axis names and sizes over ``group`` (None: the default group), and
    this rank's coordinates, in row-major order as ``jax.sharding.Mesh``
    lays out its devices."""

    def __init__(self, axes: dict[str, int], group=None):
        from .comm import Ledger

        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = math.prod(axes.values())
        self.ledger = Ledger()

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    @property
    def coords(self) -> dict[str, int]:
        out, r = {}, self.rank
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def axis_index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(axes: dict[str, int] | None = None, group=None) -> Mesh:
    """A mesh over the ranks of ``group`` (default: the whole default
    group); default axes: every rank on the data axis.

    ``make_mesh({"data": 4})`` under a group of 4 ranks.  The group must be
    initialized (:func:`.distributed.initialize`, or ``torchrun``).  Asking
    for more ranks than the group has raises ``ValueError``, as the JAX
    package does for devices; asking for fewer raises too (make a group of
    exactly that many with ``torch.distributed.new_group``).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call "
                           "parallel.initialize() or start the ranks with torchrun")
    world = dist.get_world_size(group)
    if axes is None:
        axes = {DATA_AXIS: world}
    n = math.prod(axes.values())
    if n > world:
        raise ValueError(f"mesh needs {n} ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh uses {n} of the group's {world} ranks; pass a group of "
                         f"exactly {n} ranks (torch.distributed.new_group)")
    if axes.get(PROJ_AXIS, 1) > 1:
        raise NotImplementedError("sharding the projection axis (proj > 1) is ROADMAP "
                                  "item 16b; shard the data axis only")
    if sum(k > 1 for k in axes.values()) > 1:
        raise NotImplementedError("a mesh shards along one axis here; two-axis meshes "
                                  "are ROADMAP item 16b")
    return Mesh(axes, group)
