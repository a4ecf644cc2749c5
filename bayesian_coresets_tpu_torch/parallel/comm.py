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

:class:`Ledger` counts the calls and bytes of every exchange by kind: the
port's counterpart of the JAX package's audit of compiled collectives
(``utils/hlo.py::collective_stats``, ``tests/test_sharding_hlo.py``), which
shows that a build's collective volume does not depend on n.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh


class Ledger:
    """Calls and bytes (one rank's payload) of the exchanges, by kind."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}

    def reset(self):
        self.calls.clear()
        self.bytes.clear()

    def add(self, kind: str, nbytes: int):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes

    def totals(self, kinds=None) -> tuple[int, int]:
        """(calls, bytes) summed over ``kinds`` (default: all)."""
        kinds = self.calls if kinds is None else kinds
        return (sum(self.calls.get(k, 0) for k in kinds),
                sum(self.bytes.get(k, 0) for k in kinds))


class Comm:
    """This rank's exchanges along one axis of ``mesh``.

    For a row-sharded problem, the rank owns the contiguous global rows
    ``[lo, lo + n_loc)`` with ``lo = rank * n_loc`` (every rank holds the
    same ``n_loc``).  An axis of size 1 under a larger group exchanges
    nothing; a group of one rank still goes through ``torch.distributed``.
    """

    def __init__(self, mesh: Mesh, axis: str, n_loc: int = 0):
        self.mesh = mesh
        self.ledger = mesh.ledger
        self.world = mesh.axis_size(axis)
        self.rank = mesh.axis_index(axis)
        self._live = self.world == mesh.size
        self.n_loc = int(n_loc)
        self.lo = self.rank * self.n_loc

    def all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Sum ``t`` over the axis, in place; recorded under ``kind``."""
        if self._live:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.mesh.group)
            self.ledger.add(kind, t.numel() * t.element_size())
        return t

    def local(self, idcs: torch.Tensor):
        """(local row, owned here) for global row indices; the local row is
        clamped into range where another rank owns the row."""
        j = idcs.long() - self.lo
        mine = (j >= 0) & (j < self.n_loc)
        return j.clamp(0, self.n_loc - 1), mine

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
        first maximum: (score, global index) pairs, exact in float64, go
        through one (world, 2) exchange, and the first maximal slot in rank
        order wins, which with contiguous row blocks is the first-occurrence
        tie-break of one process.  An all-invalid shard scores -inf.
        Returns (int32 index, f32 score), 0-dim on the data's device."""
        pair = torch.stack([score.double(), f_loc.double() + float(self.lo)])
        allp = self.slots(pair, kind)
        best = allp.index_select(0, torch.argmax(allp[:, 0]).view(1))[0]
        return best[1].to(torch.int32), best[0].float()

    def sum(self, x: torch.Tensor, kind: str = "sum") -> torch.Tensor:
        """The axis-wide sum of ``x`` (a copy)."""
        return self.all_reduce(x.clone(), kind)

    def any(self, flags: torch.Tensor, kind: str = "any") -> bool:
        """Whether any entry of ``flags`` is set on any rank (a host read)."""
        return bool(self.all_reduce(flags.any().to(torch.int32).view(1), kind)[0] > 0)
