"""Peaks of the card and the least time a piece of work needs on it.

The least time is the larger of two bounds: the bytes the work must move,
each input byte read once and each output byte written once, over the HBM
rate, and the operations it must do over the peak rate of their type.  Both
are counted from shapes alone, so they stay the same whatever implements the
work.  Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's
data sheet, dense rates).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"int8": 1979e12, "bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
ELEMENT_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(the least seconds, "bytes" or "operations": which bound holds)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[kind]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def select_work(n: int, Sp: int, S: int, dtype: str) -> tuple[int, int]:
    """(bytes, operations) of one GIGA select over an (n, Sp) selection copy
    with S-long directions: the copy, the valid flags, the norms (read for
    bfloat16 and float32 only), the two float32 directions and the
    (index, score) out; a multiply and an add per element and direction."""
    nbytes = n * Sp * ELEMENT_BYTES[dtype] + n + S * 2 * 4 + 8
    if dtype != "int8":
        nbytes += 4 * n
    return nbytes, 4 * n * Sp


def giga_iteration_work(n: int, Sp: int, S: int, dtype: str) -> tuple[int, int]:
    """(bytes, operations) one GIGA iteration needs: its select, then the
    O(S) rest, the chosen row (S float32 values), b and the cached image
    A w read and the image written, and some tens of operations per
    coordinate for the directions, the reweight and the error."""
    nbytes, ops = select_work(n, Sp, S, dtype)
    return nbytes + 4 * 4 * S, ops + 32 * S
