"""The exchanges of a sharded build or sampler, each one ``all_reduce``.

Counterpart of the SPMD access primitives of the JAX package's
``ops/snnls.py`` (:205-370 there), which run inside ``jax.shard_map`` as
``psum`` and ``all_gather``.  Here every exchange is one
``torch.distributed.all_reduce(SUM)`` of a small tensor: gloo reduces CUDA
tensors but does not gather them, so an all_reduce is the one collective
that NCCL and gloo, CPU and CUDA tensors all have.

Gathers become exact sums: each rank writes what it owns into its place of
the payload and ``-0.0`` everywhere else.  ``-0.0`` is the identity of
floating-point addition (``x + -0.0 == x`` for every x, ``-0.0`` and NaN
included), so the reduced payload holds the owner's values bit for bit,
and every rank then computes from the same values what one process
computes from its own.

:class:`Ledger` counts the calls and bytes of every exchange by kind, and
by axis and kind: the port's counterpart of the JAX package's audit of
compiled collectives (``utils/hlo.py::collective_stats``,
``tests/test_sharding_hlo.py``), which shows that a build's collective
volume does not depend on n.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh


class Ledger:
    """Calls and bytes (one rank's payload) of the exchanges, by kind
    (``calls``, ``bytes``, over every axis) and by axis and kind
    (``by_axis[axis][kind] = [calls, bytes]``)."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.by_axis: dict[str, dict[str, list[int]]] = {}

    def reset(self):
        self.calls.clear()
        self.bytes.clear()
        self.by_axis.clear()

    def add(self, kind: str, nbytes: int, axis: str = ""):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        entry = self.by_axis.setdefault(axis, {}).setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += nbytes

    def totals(self, kinds=None) -> tuple[int, int]:
        """(calls, bytes) summed over ``kinds`` (default: all)."""
        kinds = self.calls if kinds is None else kinds
        return (sum(self.calls.get(k, 0) for k in kinds),
                sum(self.bytes.get(k, 0) for k in kinds))


class Comm:
    """This rank's exchanges along one axis of ``mesh``, over the line of
    ranks that differ in that axis's coordinate only (``world`` of them;
    ``rank`` is this one's place on the line).

    For a row-sharded problem, the rank owns the contiguous global rows
    ``[lo, lo + n_loc)`` with ``lo = rank * n_loc`` (every rank holds the
    same ``n_loc``) of ``n`` rows (default ``world * n_loc``, padding
    included).  An axis of size 1 under a larger group exchanges nothing;
    a group of one rank still goes through ``torch.distributed``.
    ``proj`` is the proj axis's :class:`Comm` of a build that also shards
    the projection dimension (None where it does not).
    """

    proj = None

    def __init__(self, mesh: Mesh, axis: str, n_loc: int = 0, n: int | None = None):
        self.mesh = mesh
        self.ledger = mesh.ledger
        self.axis = axis
        self.world = mesh.axis_size(axis)
        self.rank = mesh.axis_index(axis)
        self._live = self.world > 1 or mesh.size == 1
        self._group = mesh.axis_group(axis) if self.world > 1 else mesh.group
        self.n_loc = int(n_loc)
        self.n = self.world * self.n_loc if n is None else int(n)
        self.lo = self.rank * self.n_loc

    def all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Sum ``t`` over the axis, in place; recorded under ``kind``."""
        if self._live:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group)
            self.ledger.add(kind, t.numel() * t.element_size(), self.axis)
        return t

    def local(self, idcs: torch.Tensor, rows: int | None = None):
        """(local row, owned here) for global row indices, of this rank's
        ``rows`` rows from ``lo`` (default ``n_loc``); the local row is
        clamped into range where another rank owns the row."""
        rows = self.n_loc if rows is None else rows
        j = idcs.long() - self.lo
        mine = (j >= 0) & (j < rows)
        return j.clamp(0, rows - 1), mine

    def owned(self, block: torch.Tensor, mine: torch.Tensor, kind: str) -> torch.Tensor:
        """``block`` (K, ...) computed at this rank's local rows, reduced so
        that entry k holds the value of the rank whose ``mine[k]`` is set
        (``-0.0`` where no rank's is)."""
        m = mine.view((-1,) + (1,) * (block.dim() - 1))
        return self.all_reduce(torch.where(m, block, -0.0), kind)

    def slots(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """Every rank's ``x``, stacked in rank order: (world,) + x.shape."""
        fill = -0.0 if x.dtype.is_floating_point else 0
        out = torch.full((self.world,) + tuple(x.shape), fill, dtype=x.dtype, device=x.device)
        out[self.rank] = x
        return self.all_reduce(out, kind)

    def gather(self, x: torch.Tensor, kind: str = "gather") -> torch.Tensor:
        """The ranks' blocks ``x`` (b, ...) concatenated in rank order."""
        return self.slots(x, kind).reshape((self.world * x.shape[0],) + tuple(x.shape[1:]))

    def argmax(self, f_loc: torch.Tensor, score: torch.Tensor, kind: str = "argmax"):
        """Global (index, score) of the first maximum from each rank's local
        first maximum (:meth:`first_max` of the global indices ``lo +
        f_loc``: with contiguous row blocks, the first-occurrence tie-break
        of one process).  An all-invalid shard scores -inf.  Returns (int32
        index, f32 score), 0-dim on the data's device."""
        f, s = self.first_max(f_loc.double() + float(self.lo), score, kind)
        return f.to(torch.int32), s.float()

    def first_max(self, index: torch.Tensor, score: torch.Tensor, kind: str = "argmax"):
        """(index, score) of the largest of the ranks' scores, ties to the
        lowest index: each rank passes its own best (0-dim ``score`` and
        global ``index``, exact in float64), one (world, 2) exchange.
        Returns (int64 index, score in ``score``'s dtype), 0-dim."""
        allp = self.slots(torch.stack([score.double(), index.double()]), kind)
        top = torch.max(allp[:, 0])
        k = torch.argmin(torch.where(allp[:, 0] == top, allp[:, 1], float("inf")))
        return allp[k, 1].long(), allp[k, 0].to(score.dtype)

    def sum(self, x: torch.Tensor, kind: str = "sum") -> torch.Tensor:
        """The axis-wide sum of ``x`` (a copy)."""
        return self.all_reduce(x.clone(), kind)

    def any(self, flags: torch.Tensor, kind: str = "any") -> bool:
        """Whether any entry of ``flags`` is set on any rank (a host read)."""
        return bool(self.all_reduce(flags.any().to(torch.int32).view(1), kind)[0] > 0)
