"""Sharded Hilbert builds over the ranks of a mesh: rows along the data
axis, and with ``shard_proj=True`` columns along the proj axis too.

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

A shard is a contiguous block of ``ceil(n / data)`` rows, rank r the
block from ``r * ceil(n / data)``; the last blocks are padded with zero
rows that are ``valid=False`` (norm 1, probability 0).  The JAX package
pads to a multiple of ``lcm(data, 1024)`` for its Pallas tile
(coreset.py:150-187 there); this package's select kernel takes any row
count, so only the data axis's size is padded to.

With ``shard_proj=True`` on a mesh whose proj axis has more than one rank,
each rank also keeps one contiguous block of ``ceil(S / proj)`` columns
(zero-padded; b and the cached image xw by the same blocks), and the
build's sums over S and its select's dots are summed over the proj axis
(``ops/snnls.py``, ``comm.proj``).  The norms, the valid mask and the int8
selection copy are made from the full rows before they are sliced, so the
copy's columns are the single-process copy's bit for bit, and the summed
int32 dots are its dots.  Each rank's block of the copy is padded to whole
16-byte rows for the select kernel.  The JAX package pads S to
``lcm(proj, 128)`` (int8) or ``proj`` first; zero columns change no dot of
this package's (f64 partial sums, exact int32 dots), so only the column
blocks' own width is padded to.  Orthogonal matching pursuit, whose
active-set NNLS needs whole rows, refuses the proj axis (as the JAX
package's does), and so do int8-resident constants.

Each function takes the global problem, on every rank, and keeps this
rank's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import snnls
from ..ops.giga_select import col_multiple
from ..utils import config
from .comm import Comm
from .mesh import DATA_AXIS, PROJ_AXIS, Mesh

_CHUNK_BYTES = 256 << 20    # f32 full-width rows per step of the proj-sharded setup


def row_block(n: int, mesh: Mesh) -> tuple[int, int]:
    """(first global row, rows per rank) of this rank's block of n rows."""
    per = -(-n // mesh.axis_size(DATA_AXIS))
    return mesh.axis_index(DATA_AXIS) * per, per


def col_block(S: int, mesh: Mesh) -> tuple[int, int]:
    """(first column, columns per rank) of this rank's block of S columns
    along the proj axis."""
    per = -(-S // mesh.axis_size(PROJ_AXIS))
    return mesh.axis_index(PROJ_AXIS) * per, per


def local_rows(x: torch.Tensor, lo: int, per: int, fill=0) -> torch.Tensor:
    """Rows [lo, lo + per) of x (a copy), padded with ``fill`` past its end."""
    part = x[min(lo, x.shape[0]):lo + per]
    pad = per - part.shape[0]
    if pad == 0:
        return part.clone()
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([part, tail])


def local_cols(x: torch.Tensor, lo: int, per: int) -> torch.Tensor:
    """Columns [lo, lo + per) of x (..., S), contiguous, zero-padded past S."""
    part = x[..., min(lo, x.shape[-1]):lo + per]
    return F.pad(part, (0, per - part.shape[-1])).contiguous()


def _proj_split(mesh: Mesh, shard_proj: bool) -> bool:
    return bool(shard_proj) and mesh.axis_size(PROJ_AXIS) > 1


def sharded_comm(mesh: Mesh, consts: snnls.SNNLSConsts, shard_proj: bool = False) -> Comm:
    """The exchanges of this rank's block: the data axis's, with the proj
    axis's beside them (``comm.proj``) where ``shard_proj`` splits S."""
    comm = snnls._data_comm(mesh, consts)
    if _proj_split(mesh, shard_proj):
        comm.proj = Comm(mesh, PROJ_AXIS)
    return comm


def _slice_cols(consts: snnls.SNNLSConsts, mesh: Mesh) -> snnls.SNNLSConsts:
    """This rank's column block of constants whose rows are already its
    own: V, Vsel and b sliced, Vsel padded to whole 16-byte rows."""
    c0, per = col_block(consts.V.shape[1], mesh)
    V = local_cols(consts.V, c0, per)
    sel = V if consts.Vsel is consts.V else local_cols(consts.Vsel, c0, per)
    return consts._replace(V=V, b=local_cols(consts.b, c0, per),
                           Vsel=snnls._pad_cols(sel, col_multiple(sel.dtype)))


def shard_consts(consts: snnls.SNNLSConsts, mesh: Mesh,
                 shard_proj: bool = False) -> snnls.SNNLSConsts:
    """This rank's rows of global solver constants (the rest is kept
    whole): V, Vsel, norms, valid and ps by rows, padded rows zero with
    norm 1, invalid and of probability 0; with ``shard_proj`` on a split
    proj axis, V, Vsel and b by this rank's column block too (norms and
    ``bnorm`` stay the full rows' and b's)."""
    lo, per = row_block(consts.V.shape[0], mesh)
    V = local_rows(consts.V, lo, per)
    Vsel = V if consts.Vsel is consts.V else local_rows(consts.Vsel, lo, per)
    ps = local_rows(consts.ps, lo, per) if consts.ps.shape[0] else consts.ps
    out = consts._replace(V=V, Vsel=Vsel, norms=local_rows(consts.norms, lo, per, 1.0),
                          valid=local_rows(consts.valid, lo, per, False), ps=ps)
    if _proj_split(mesh, shard_proj):
        if consts.V.dtype == torch.int8:
            raise ValueError("int8-resident constants shard the data axis only "
                             "(shard_proj=False)")
        out = _slice_cols(out, mesh)
    return out


def shard_state(state: snnls.SNNLSState, mesh: Mesh,
                shard_proj: bool = False) -> snnls.SNNLSState:
    """This rank's rows of a global solver state (w and the counts), and
    with ``shard_proj`` on a split proj axis its column block of xw."""
    lo, per = row_block(state.w.shape[0], mesh)
    cts = local_rows(state.cts, lo, per) if state.cts.shape[0] else state.cts
    out = state._replace(w=local_rows(state.w, lo, per), cts=cts)
    if _proj_split(mesh, shard_proj):
        out = out._replace(xw=local_cols(state.xw, *col_block(state.xw.shape[0], mesh)))
    return out


def _proj_consts(A, b, mesh: Mesh, valid, sampling, select_dtype):
    """:func:`make_sharded_consts` on a split proj axis.  A numpy ``A``
    stays on the host (a tensor where it is); this rank's rows go to the
    device in chunks of about ``_CHUNK_BYTES`` of full rows, each made into
    norms, valid and selection copy by :func:`..ops.snnls.row_consts` and
    then sliced to the rank's columns, so no rank holds the whole (n, S)
    problem on the device."""
    if isinstance(A, torch.Tensor):
        dev = A.device
        A = A.to(config.default_dtype())
    else:
        dev = config.default_device()
        A = torch.as_tensor(A, dtype=config.default_dtype())
    b = config.on_device(b, config.default_dtype(), dev, "b")
    S, n = A.shape
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else config.on_device(valid, torch.bool, dev, "valid"))
    lo, per = row_block(n, mesh)
    c0, width = col_block(S, mesh)
    step = max(1, _CHUNK_BYTES // (4 * S))
    V, Vsel, norms, ok = [], [], [], []
    for r0 in range(lo, lo + per, step):
        rows = min(step, lo + per - r0)
        Vc = local_rows(A.T, r0, rows).to(dev).contiguous()      # (rows, S), full width
        nc, vc, sc = snnls.row_consts(Vc, local_rows(valid, r0, rows, False), select_dtype)
        V.append(local_cols(Vc, c0, width))
        Vsel.append(None if sc is Vc else local_cols(sc, c0, width))
        norms.append(nc)
        ok.append(vc)
    V, norms, ok = torch.cat(V), torch.cat(norms), torch.cat(ok)
    Vsel = V if Vsel[0] is None else torch.cat(Vsel)
    comm = Comm(mesh, DATA_AXIS, per)
    return snnls.SNNLSConsts(V, local_cols(b, c0, width), norms, torch.sqrt(torch.sum(b * b)),
                             ok, snnls._sampling_ps(norms, ok, sampling, comm),
                             snnls._pad_cols(Vsel, col_multiple(Vsel.dtype)))


def make_sharded_consts(A, b, mesh: Mesh, valid=None, sampling=None, select_dtype=None,
                        shard_proj: bool = False):
    """This rank's solver constants of the problem (A (S, n), b (S,)):
    the rank's columns of A become its rows of V (and with ``shard_proj``
    on a split proj axis, its block of A's rows its columns of V), and the
    sums over n (the sampling probabilities' normalizer) run over every
    rank of the data axis.  Returns (consts, n, S)."""
    if _proj_split(mesh, shard_proj):
        consts = _proj_consts(A, b, mesh, valid, sampling, select_dtype)
        return consts, A.shape[1], A.shape[0]
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


def _run(consts, comm, itrs, method, draws, max_active, n, S=None):
    """Build on this rank's block; the state comes back with the global
    weights and counts (one exchange each), trimmed to n rows, and under
    proj sharding the global cached image (one more), trimmed to S."""
    state = snnls.init_state(consts, max_active)
    state = snnls.build(consts, state, itrs, config.TOL, method=method, draws=draws,
                        matvec_k=max_active, comm=comm)
    cts = comm.gather(state.cts)[:n] if state.cts.shape[0] else state.cts
    state = state._replace(w=comm.gather(state.w)[:n], cts=cts)
    if comm.proj is not None:
        state = state._replace(xw=comm.proj.gather(state.xw)[:S])
    return state


def build_sharded(A, b, itrs: int, mesh: Mesh, method: str = "giga", valid=None,
                  draws=None, shard_proj: bool = False, max_active: int | None = None,
                  select_dtype=None) -> snnls.SNNLSState:
    """Run a sharded build of ``method`` (collective: every rank calls it
    with the same arguments).  Returns the final state with the global
    weights (and counts) on every rank, trimmed to the caller's n.

    ``shard_proj=True`` splits S over the mesh's proj axis too (where it
    has more than one rank); ``method="orthopursuit"`` then raises
    ``ValueError``.  Over a mesh with a proj axis and ``shard_proj=False``,
    every line along proj runs the same data-sharded build.
    ``max_active`` defaults to min(n, 1024) slots: a sharded build tracks
    its support (the JAX package's default of 0 slots refreshes by a dense
    matvec instead).  ``draws``: the sampling solvers' generator, seeded
    alike on every rank (default: a fresh generator on the data's device).
    """
    if method == "orthopursuit" and _proj_split(mesh, shard_proj):
        raise ValueError("orthopursuit's active-set NNLS needs full-S rows; shard the data "
                         "axis only (shard_proj=False)")
    consts, n, S = make_sharded_consts(A, b, mesh, valid=valid, sampling=_sampling(method),
                                       select_dtype=select_dtype, shard_proj=shard_proj)
    K = min(n, 1024) if max_active is None else int(max_active)
    return _run(consts, sharded_comm(mesh, consts, shard_proj), itrs, method, draws, K, n, S)


def build_sharded_quantized(Vq, norms, b, itrs: int, mesh: Mesh, method: str = "giga",
                            valid=None, draws=None,
                            max_active: int = 1024) -> snnls.SNNLSState:
    """Row-sharded build over int8-resident constants (``Vq`` (n, S) int8
    normalized rows, ``norms`` (n,)): each rank keeps 1/data of the int8
    matrix.  As :func:`build_sharded` otherwise (the data axis only, as in
    the JAX package)."""
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
    return _run(consts, sharded_comm(mesh, consts), itrs, method, draws, int(max_active), n)
