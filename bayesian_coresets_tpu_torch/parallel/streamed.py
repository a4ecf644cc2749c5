"""Streamed int8-resident construction: the per-chunk quantization.

Port of ``round_up`` and ``quantize_chunk`` of
``bayesian_coresets_tpu/parallel/streamed.py`` (:40-57 there).  A
projection chunk becomes the int8-resident representation that
:func:`..ops.snnls.make_consts_quantized` takes: each row normalized to
unit length and scaled to ±127, beside its f32 norm.  The single-device
streamed constructor (``HilbertCoreset(stream_chunk_size=...)``) calls it
once per chunk; the sharded step, the row layout and
``make_streamed_quantized_consts`` of the JAX module belong to the
multi-GPU port (ROADMAP item 16) and are not here.
"""

from __future__ import annotations

import torch

from ..ops.giga_select import sqrt_rn

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
