"""Meshes over a ``torch.distributed`` process group.

Port of ``bayesian_coresets_tpu/parallel/mesh.py``.  There, one process
lays its devices out in a ``jax.sharding.Mesh`` and XLA inserts the
collectives.  Here one process drives one GPU (SPMD, as ``torchrun``
starts them), and a mesh names how the ranks of an initialized process
group split the work:

- ``DATA_AXIS`` shards the dataset rows (N) of a Hilbert build, SparseVI
  and BatchPSVI;
- ``PROJ_AXIS`` shards the projection dimension S of a Hilbert build
  (``build_sharded(shard_proj=True)``);
- ``CHAIN_AXIS`` shards the chains of weighted NUTS.

A mesh may split several axes, ``make_mesh({"data": 2, "proj": 2})``: the
ranks lie in JAX's row-major order, and an exchange along one axis runs
over the line of ranks that differ only in that axis's coordinate, a
``torch.distributed`` subgroup that the mesh makes (:meth:`Mesh.axis_group`).
Values are repeated over the axes that a computation does not shard.  The
mesh also owns the collective ledger (:class:`.comm.Ledger`) that every
exchange made over it records into.
"""

from __future__ import annotations

import math

import torch.distributed as dist

DATA_AXIS = "data"     # shards dataset rows (N)
PROJ_AXIS = "proj"     # shards the projection dimension (S)
CHAIN_AXIS = "chains"  # shards MCMC chains


class Mesh:
    """Axis names and sizes over ``group`` (None: the default group), and
    this rank's coordinates, in row-major order as ``jax.sharding.Mesh``
    lays out its devices.  Made by :func:`make_mesh`, which also makes the
    subgroups of the axes that split the group only in part."""

    def __init__(self, axes: dict[str, int], group=None):
        from .comm import Ledger

        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = math.prod(axes.values())
        self.ledger = Ledger()
        self._groups = {}

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def axis_group(self, name: str):
        """The process group of this rank's line along ``name``: the mesh's
        own group where the axis spans every rank, else the subgroup that
        :func:`make_mesh` made (None for an axis of size 1)."""
        if self.axis_size(name) == self.size:
            return self.group
        return self._groups.get(name)

    def lines(self, name: str) -> list[list[int]]:
        """The lines of group ranks along axis ``name``, in the mesh's
        order: each is the ranks whose other coordinates agree."""
        stride = math.prod(self.shape[a] for a in self.axis_names[self.axis_names.index(name) + 1:])
        k = self.shape[name]
        starts = [r for r in range(self.size) if (r // stride) % k == 0]
        return [[s + i * stride for i in range(k)] for s in starts]

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

    ``make_mesh({"data": 4})`` under a group of 4 ranks, ``make_mesh({"data":
    2, "proj": 2})`` or ``{"data": 2, "chains": 2}`` under 4.  The group must
    be initialized (:func:`.distributed.initialize`, or ``torchrun``).
    Asking for more ranks than the group has raises ``ValueError``, as the
    JAX package does for devices; asking for fewer raises too (make a group
    of exactly that many with ``torch.distributed.new_group``).

    Collective: for an axis that splits the group only in part, every rank
    makes one ``torch.distributed.new_group`` per line of ranks along it, in
    the same order (axes in the mesh's order, lines in row-major order),
    including the lines it is not in, as ``new_group`` requires of every
    rank of the default group.  So such a mesh is made over the whole
    default group, by all its ranks.
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
    mesh = Mesh(axes, group)
    split = [a for a in mesh.axis_names if 1 < mesh.shape[a] < n]
    if split and world != dist.get_world_size():
        raise ValueError(f"a mesh that splits {split} in part makes subgroups, which every "
                         "rank of the default group must make: build it over the whole "
                         "default group")
    for name in split:
        for line in mesh.lines(name):
            g = dist.new_group(line if group is None
                               else [dist.get_global_rank(group, r) for r in line])
            if mesh.rank in line:
                mesh._groups[name] = g
    return mesh
