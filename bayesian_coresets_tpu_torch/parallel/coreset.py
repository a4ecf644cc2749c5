"""Row-sharded Hilbert builds over the ranks of a mesh's data axis.

Port of ``bayesian_coresets_tpu/parallel/coreset.py``.  The plan is the
JAX package's: V = A.T (n, S) is split by rows, every rank selects over its
own rows each iteration, and the reads by global index are explicit
exchanges (``parallel/comm.py``, used by ``ops/snnls.py``'s ``comm=``), so
each rank streams its own rows once per iteration and the collective
volume does not depend on n.  There ``jax.shard_map`` runs one program
over the mesh's devices; here every rank is a process that runs
:func:`..ops.snnls.build` on its block of rows, and the replicated state
(the cached image, the support slots, ``done``) agrees on every rank
because each computes it from the same exchanged values.

A shard is a contiguous block of ``ceil(n / world)`` rows, rank r the
block from ``r * ceil(n / world)``; the last blocks are padded with zero
rows that are ``valid=False`` (norm 1, probability 0).  The JAX package
pads to a multiple of ``lcm(world, 1024)`` for its Pallas tile
(coreset.py:150-187 there); this package's select kernel takes any row
count, so only the world size is padded to.

Each function takes the global problem, on every rank, and keeps this
rank's rows.  Sharding the projection axis (``shard_proj=True``) is ROADMAP
item 16b and raises.
"""

from __future__ import annotations

import torch

from ..ops import snnls
from ..utils import config
from .comm import Comm
from .mesh import DATA_AXIS, Mesh


def _no_proj(shard_proj: bool):
    if shard_proj:
        raise NotImplementedError("sharding the projection axis (shard_proj=True) is ROADMAP "
                                  "item 16b; shard the data axis only")


def row_block(n: int, mesh: Mesh) -> tuple[int, int]:
    """(first global row, rows per rank) of this rank's block of n rows."""
    per = -(-n // mesh.axis_size(DATA_AXIS))
    return mesh.axis_index(DATA_AXIS) * per, per


def local_rows(x: torch.Tensor, lo: int, per: int, fill=0) -> torch.Tensor:
    """Rows [lo, lo + per) of x (a copy), padded with ``fill`` past its end."""
    part = x[min(lo, x.shape[0]):lo + per]
    pad = per - part.shape[0]
    if pad == 0:
        return part.clone()
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([part, tail])


def shard_consts(consts: snnls.SNNLSConsts, mesh: Mesh,
                 shard_proj: bool = False) -> snnls.SNNLSConsts:
    """This rank's rows of global solver constants (the rest is kept
    whole): V, Vsel, norms, valid and ps by rows, padded rows zero with
    norm 1, invalid and of probability 0."""
    _no_proj(shard_proj)
    lo, per = row_block(consts.V.shape[0], mesh)
    V = local_rows(consts.V, lo, per)
    Vsel = V if consts.Vsel is consts.V else local_rows(consts.Vsel, lo, per)
    ps = local_rows(consts.ps, lo, per) if consts.ps.shape[0] else consts.ps
    return consts._replace(V=V, Vsel=Vsel, norms=local_rows(consts.norms, lo, per, 1.0),
                           valid=local_rows(consts.valid, lo, per, False), ps=ps)


def shard_state(state: snnls.SNNLSState, mesh: Mesh,
                shard_proj: bool = False) -> snnls.SNNLSState:
    """This rank's rows of a global solver state (w and the counts)."""
    _no_proj(shard_proj)
    lo, per = row_block(state.w.shape[0], mesh)
    cts = local_rows(state.cts, lo, per) if state.cts.shape[0] else state.cts
    return state._replace(w=local_rows(state.w, lo, per), cts=cts)


def make_sharded_consts(A, b, mesh: Mesh, valid=None, sampling=None, select_dtype=None,
                        shard_proj: bool = False):
    """This rank's solver constants of the problem (A (S, n), b (S,)):
    the rank's columns of A become its rows of V, and the sums over n (the
    sampling probabilities' normalizer) run over every rank.  Returns
    (consts, n, S)."""
    _no_proj(shard_proj)
    A = config.as_tensor(A, config.default_dtype())
    b = config.on_device(b, config.default_dtype(), A.device, "b")
    S, n = A.shape
    valid = (torch.ones(n, dtype=torch.bool, device=A.device) if valid is None
             else config.on_device(valid, torch.bool, A.device, "valid"))
    lo, per = row_block(n, mesh)
    At = local_rows(A.T, lo, per)                    # (per, S): this rank's rows of V
    consts = snnls.make_consts(At.T, b, valid=local_rows(valid, lo, per, False),
                               select_dtype=select_dtype, sampling=sampling,
                               comm=Comm(mesh, DATA_AXIS, per))
    return consts, n, S


def _sampling(method: str):
    return method if method in ("importance", "uniform") else None


def _run(consts, mesh, itrs, method, draws, max_active, n):
    """Build on this rank's block; the state comes back with the global
    weights and counts (one exchange each), trimmed to n rows."""
    comm = snnls._data_comm(mesh, consts)
    state = snnls.init_state(consts, max_active)
    state = snnls.build(consts, state, itrs, config.TOL, method=method, draws=draws,
                        matvec_k=max_active, comm=comm)
    cts = comm.gather(state.cts)[:n] if state.cts.shape[0] else state.cts
    return state._replace(w=comm.gather(state.w)[:n], cts=cts)


def build_sharded(A, b, itrs: int, mesh: Mesh, method: str = "giga", valid=None,
                  draws=None, shard_proj: bool = False, max_active: int | None = None,
                  select_dtype=None) -> snnls.SNNLSState:
    """Run a row-sharded build of ``method`` (collective: every rank calls
    it with the same arguments).  Returns the final state with the global
    weights (and counts) on every rank, trimmed to the caller's n.

    ``max_active`` defaults to min(n, 1024) slots: a sharded build tracks
    its support (the JAX package's default of 0 slots refreshes by a dense
    matvec instead).  ``draws``: the sampling solvers' generator, seeded
    alike on every rank (default: a fresh generator on the data's device).
    """
    consts, n, _ = make_sharded_consts(A, b, mesh, valid=valid, sampling=_sampling(method),
                                       select_dtype=select_dtype, shard_proj=shard_proj)
    K = min(n, 1024) if max_active is None else int(max_active)
    return _run(consts, mesh, itrs, method, draws, K, n)


def build_sharded_quantized(Vq, norms, b, itrs: int, mesh: Mesh, method: str = "giga",
                            valid=None, draws=None,
                            max_active: int = 1024) -> snnls.SNNLSState:
    """Row-sharded build over int8-resident constants (``Vq`` (n, S) int8
    normalized rows, ``norms`` (n,)): each rank keeps 1/world of the int8
    matrix.  As :func:`build_sharded` otherwise."""
    Vq = config.as_tensor(Vq)
    n = Vq.shape[0]
    norms = config.on_device(norms, torch.float32, Vq.device, "norms")
    valid = (torch.ones(n, dtype=torch.bool, device=Vq.device) if valid is None
             else config.on_device(valid, torch.bool, Vq.device, "valid"))
    lo, per = row_block(n, mesh)
    consts = snnls.make_consts_quantized(
        local_rows(Vq, lo, per), local_rows(norms, lo, per, 1.0),
        config.on_device(b, torch.float32, Vq.device, "b"),
        valid=local_rows(valid, lo, per, False), sampling=_sampling(method),
        comm=Comm(mesh, DATA_AXIS, per))
    return _run(consts, mesh, itrs, method, draws, int(max_active), n)

