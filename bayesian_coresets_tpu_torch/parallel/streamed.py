"""Streamed int8-resident construction, on one device or row-sharded.

Port of ``bayesian_coresets_tpu/parallel/streamed.py``.  A projection
chunk becomes the int8-resident representation that
:func:`..ops.snnls.make_consts_quantized` takes: each row normalized to
unit length and scaled to ±127, beside its f32 norm
(:func:`quantize_chunk`, :40-57 there).  :func:`stream_quantized` runs
the chunk loop of the single-device constructor
(``HilbertCoreset(stream_chunk_size=...)``);
:func:`make_streamed_quantized_consts` runs it on each rank of a
mesh's data axis over the rank's own rows (:93-260 there), so no rank
holds more than its block of the int8 matrix and one f32 chunk, and the
only exchange is one ``all_reduce`` of b's f64 partial sums.

The JAX package projects each chunk inside one ``jax.shard_map`` step
(``make_sharded_stream_step``), whose tracing is why its constructor has a
trace-error fallback; here every rank projects its chunks with the
projector's own ``project`` call, eagerly, so there is no such step and no
fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import snnls
from ..ops.giga_select import col_multiple, sqrt_rn
from ..utils import config
from .comm import Comm
from .mesh import DATA_AXIS, Mesh

# rows per f64 block of the norm and column sums: a (65536, 512) f64 block
# is 268 MB, where an f64 copy of a whole 1M-row chunk would be 4 GB
_F64_BLOCK_ROWS = 1 << 16


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def quantize_chunk(vecs: torch.Tensor, live: int):
    """f32 (C, S) projection chunk -> (int8 normalized rows (C, S), f32 norms
    (C,), f64 column sum (S,)), on the chunk's device.

    Rows at ``live`` and beyond are padding: their rows and norms are 0 and
    they add nothing to the sum.  The JAX package's order of operations is
    kept: ``clip(round(v / safe_norm * 127), -127, 127)`` with a tensor
    divisor, rounding half to even.  The norms' sums of squares and the
    column sum accumulate in f64 (in row blocks, so no f64 copy of the chunk
    exists) and the root is correctly rounded (``sqrt_rn``), so a chunk
    quantizes to the same bytes on the CPU and on the card.  The column sum
    stays f64 for the caller to accumulate over chunks.
    """
    C, S = vecs.shape
    live = max(0, min(int(live), C))
    v = vecs[:live]
    nrm = torch.zeros(C, dtype=torch.float32, device=vecs.device)
    bsum = torch.zeros(S, dtype=torch.float64, device=vecs.device)
    for r in range(0, live, _F64_BLOCK_ROWS):
        blk = v[r:r + _F64_BLOCK_ROWS].double()
        nrm[r:r + blk.shape[0]] = sqrt_rn(torch.sum(blk * blk, dim=1))
        bsum += torch.sum(blk, dim=0)
    safe = torch.where(nrm[:live] > 0, nrm[:live], 1.0)
    q = torch.zeros((C, S), dtype=torch.int8, device=vecs.device)
    scaled = v / safe[:, None]              # one f32 temporary, then in place
    q[:live] = scaled.mul_(127.0).round_().clamp_(-127, 127).to(torch.int8)
    return q, nrm, bsum


def stream_quantized(rows, m: int, n_rows: int, project_fn, chunk: int, dev,
                S: int | None = None):
    """Project and quantize rows [0, m) chunk by chunk into one int8 buffer
    of ``n_rows`` rows allocated on ``dev`` (rows past m stay zero).

    ``rows(lo, hi)`` returns the data rows [lo, hi) as a tensor on ``dev``;
    every chunk is zero-padded to ``chunk`` rows, so every projection has
    one shape.  The buffer's columns are pre-padded to whole 16-byte rows,
    so ``make_consts_quantized`` uses it as it is.  ``S``, the projection
    dimension, is read from the first chunk when not given (it must be
    given when m is 0).  Returns (buffer (n_rows, Sp) int8, norms (n_rows,)
    f32, column sum (S,) f64)."""
    buf = b = norms = None

    def alloc(S):
        Sp = round_up(S, col_multiple(torch.int8))
        return (torch.zeros((n_rows, Sp), dtype=torch.int8, device=dev),
                torch.zeros(S, dtype=torch.float64, device=dev),
                torch.zeros(n_rows, dtype=torch.float32, device=dev))

    if S is not None:
        buf, b, norms = alloc(S)
    for lo in range(0, m, chunk):
        live = min(chunk, m - lo)
        xc = rows(lo, lo + live)
        if live < chunk:                  # the last chunk, zero-padded to the chunk size
            xc = torch.cat([xc, xc.new_zeros((chunk - live,) + xc.shape[1:])])
        q, nrm, bsum = quantize_chunk(project_fn(xc), live)
        if buf is None:
            buf, b, norms = alloc(q.shape[1])
        buf[lo:lo + live, :q.shape[1]].copy_(q[:live])
        norms[lo:lo + live] = nrm[:live]
        b += bsum
        del q, nrm, bsum, xc
    if buf is None:
        raise ValueError("stream_quantized: no rows to project and no S given")
    return buf, norms, b


def streamed_row_layout(n: int, mesh: Mesh):
    """Row layout of the streamed-sharded int8 buffer: ``(rows_glob,
    rows_loc, positions, local_rows)`` as in the JAX package, where
    ``rows_glob`` is n padded to a multiple of the data axis (no 1024-row
    tile here), ``rows_loc`` the rows per rank, ``positions`` this rank's
    position along the data axis, and ``local_rows`` the slice of [0, n)
    that this rank passes to :func:`make_streamed_quantized_consts`
    (global row i is buffer row i; rank k owns buffer rows
    [k * rows_loc, (k + 1) * rows_loc))."""
    world, k = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    rows_loc = -(-n // world)
    return (world * rows_loc, rows_loc, [k],
            slice(min(k * rows_loc, n), min((k + 1) * rows_loc, n)))


def make_streamed_quantized_consts(local_rows, project_fn, chunk: int, mesh: Mesh, n: int,
                                   sampling: str | None = None, S: int | None = None,
                                   device=None) -> snnls.SNNLSConsts:
    """This rank's int8-resident constants of a row-sharded problem, built
    by streaming its own data rows (collective: every rank calls it).

    ``local_rows``: the data rows this rank owns, exactly
    ``streamed_row_layout(n, mesh).local_rows`` of the dataset (a numpy
    array or a tensor, kept where it is; chunks go to ``device``, default
    the default device).  ``project_fn(pts) -> (C, S) f32`` projects a
    chunk on that device with the same samples on every rank.  ``S``: the
    projection dimension, if known (else one row is projected to read it).
    The rank's rows are projected and quantized chunk by chunk into its own
    int8 buffer; b's f64 partial sums go through one exchange.  Returns
    constants ready for ``SparseNNLS.from_consts(consts, mesh=mesh)``."""
    _, rows_loc, _, sl = streamed_row_layout(n, mesh)
    m = local_rows.shape[0]
    if m != sl.stop - sl.start:
        raise ValueError(f"local_rows has {m} rows; this rank owns rows "
                         f"[{sl.start}, {sl.stop}) (streamed_row_layout)")
    dev = config.resolve_device(device) if device is not None else config.default_device()

    def rows(lo: int, hi: int) -> torch.Tensor:
        return torch.as_tensor(local_rows[lo:hi]).to(dev)

    if S is None:
        probe = rows(0, 1) if m else torch.as_tensor(
            np.zeros((1,) + tuple(local_rows.shape[1:]), np.float32)).to(dev)
        S = int(project_fn(probe).shape[1])
    comm = Comm(mesh, DATA_AXIS, rows_loc)
    buf, norms, b = stream_quantized(rows, m, rows_loc, project_fn, chunk, dev, S=S)
    b = comm.sum(b, "setup")
    valid = norms > 0
    if not bool(comm.sum(torch.sum(valid).double(), "setup") > 0):
        raise ValueError("all projected vectors are zero or masked")
    return snnls.make_consts_quantized(buf, norms, b.float(), valid=valid, sampling=sampling,
                                       comm=comm)
