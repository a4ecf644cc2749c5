"""The packed-int4 select: GIGA's select over rows of two 4-bit values a byte.

Counterpart of ``scripts/probe_int4_pallas.py::packed_select`` in the JAX
package.  That kernel is a bandwidth probe: it asks whether streaming a
packed (n, S/2) copy beats streaming the (n, S) int8 copy that the GIGA
select (``ops/giga_select.py``) reads.  Its scores are unnormalized on
purpose: the dequantization constant 1/(7*127) ignores the sqrt(S)/4 factor
of the probe's quantization scale, and there is no ``geo_ok`` guard.  The
port computes exactly what the probe computes.  ``snnls`` never calls it.

    (a0, a1) = lo(P[r]) . q[0::2] + hi(P[r]) . q[1::2]     int32
    (d0, d1) = f32(a) * f32(1/(7*127)) * nrminv[r]
    score    = d0 / sqrt(clip(1 - d1^2, 1e-30)) + bias[r]
    result   = (first index of the maximum, that score)

with q = clip(round(127 dirs2), -127, 127) and byte j of a packed row holding
column 2j in its low nibble and column 2j+1 in its high one.

:func:`packed_select` launches the hand-written CUDA kernel
(``csrc/packed_select.cu``) for CUDA tensors, one launch per select, and
uses the plain PyTorch version :func:`packed_select_ref` for CPU tensors;
there is no other route and no fallback.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda_build
from .giga_select import sqrt_rn, workspace

launches = 0   # kernel launches by packed_select (plain-version calls not counted)

_CHUNK = 16                                   # bytes per kernel load


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(n, S) int8 in [-8, 7], S even -> (n, S/2) int8: column 2j in the low
    nibble of byte j, column 2j+1 in its high nibble (probe_int4_pallas.py:121).
    Widened to int16 first: no shift of an int8 tensor overflows."""
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] % 2:
        raise ValueError(f"pack_int4 takes an (n, even S) int8 tensor; got {q.dtype} "
                         f"{tuple(q.shape)}")
    w = q.to(torch.int16)
    return ((w[:, 0::2] & 0xF) | ((w[:, 1::2] & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(P: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, S/2) packed int8 -> sign-extended (lo, hi) nibbles as int32."""
    p = P.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, p >> 4


def quantize_dirs(dirs2: torch.Tensor) -> torch.Tensor:
    """(S, 2) f32 -> (S, 2) int8: round(127 d), half to even, clipped to
    ±127 (probe_int4_pallas.py:75)."""
    return torch.clamp(torch.round(dirs2 * 127.0), -127, 127).to(torch.int8)


def kernel_dirs(dirs2: torch.Tensor, cols: int) -> torch.Tensor:
    """The (4, cols) int8 direction rows [lo0, lo1, hi0, hi1] that the kernel
    builds in its shared memory: the even and odd rows of the quantized
    directions, zero-padded to ``cols`` (for the tests; the wrapper passes
    the f32 directions as they are)."""
    q = quantize_dirs(dirs2)
    d = torch.cat([q[0::2].T, q[1::2].T])     # (4, S/2)
    return torch.nn.functional.pad(d, (0, cols - d.shape[1])).contiguous()


def make_probe_buffers(gen: torch.Generator, n: int, S: int):
    """The probe's data (probe_int4_pallas.py:114-122): unit rows of a normal
    (n, S) draw on the generator's device, as the int8 copy V8 (round(127 v))
    and the packed copy P of round(7 sqrt(S)/4 v) clipped to ±7."""
    v = torch.randn((n, S), generator=gen, device=gen.device)
    v /= torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    V8 = torch.clamp(torch.round(v * 127.0), -127, 127).to(torch.int8)
    v *= 7.0 * math.sqrt(S) / 4.0
    P = pack_int4(torch.clamp(torch.round(v), -7, 7).to(torch.int8))
    return V8, P


def packed_select_ref(P: torch.Tensor, dirs2: torch.Tensor, nrminv: torch.Tensor,
                      bias: torch.Tensor):
    """Plain PyTorch select: (int32 index, f32 score), 0-dim tensors.

    The dots are taken in float64, exact for these integer sums (an int8
    ``@`` on the CPU returns int8 and overflows)."""
    q = quantize_dirs(dirs2).double()
    lo, hi = unpack_int4(P)
    acc = lo.double() @ q[0::2] + hi.double() @ q[1::2]
    scale = torch.tensor(1.0 / (7.0 * 127.0), dtype=torch.float32, device=P.device)
    dots = acc.float() * scale
    d0 = dots[:, 0] * nrminv
    d1 = dots[:, 1] * nrminv
    score = d0 / sqrt_rn(torch.clamp(1.0 - d1 * d1, min=1e-30)) + bias
    f = torch.argmax(score)
    return f.to(torch.int32), score[f]


def _check(P, dirs2, nrminv, bias):
    if P.dtype != torch.int8 or P.dim() != 2 or not P.is_contiguous():
        raise ValueError(f"P must be a contiguous 2-D int8 tensor; got {P.dtype} "
                         f"{tuple(P.shape)}")
    n, half = P.shape
    if not 0 < n < 2**31 or half == 0:
        raise ValueError(f"P of shape {tuple(P.shape)}: rows outside (0, 2^31) or no columns")
    if dirs2.dtype != torch.float32 or tuple(dirs2.shape) != (2 * half, 2):
        raise ValueError(f"dirs2 must be float32 (S, 2) with S = 2 * {half} (even); got "
                         f"{dirs2.dtype} {tuple(dirs2.shape)}")
    for name, t in (("nrminv", nrminv), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor")
    for t in (dirs2, nrminv, bias):
        if t.device != P.device:
            raise ValueError(f"all inputs must be on {P.device}; got {t.device}")


def padded(P: torch.Tensor) -> torch.Tensor:
    """``P`` with zero columns up to whole 16-byte chunks (zero nibbles add
    nothing to the dots); ``P`` itself when it has them already."""
    n, half = P.shape
    cols = -(-half // _CHUNK) * _CHUNK
    if cols == half and P.data_ptr() % _CHUNK == 0:
        return P
    out = torch.zeros((n, cols), dtype=P.dtype, device=P.device)
    out[:, :half] = P
    return out


def packed_select(P: torch.Tensor, dirs2: torch.Tensor, nrminv: torch.Tensor,
                  bias: torch.Tensor):
    """Packed-int4 select: (int32 index, f32 score) as 0-dim device tensors.

    P: (n, S/2) packed int8 (:func:`pack_int4`), any n; dirs2: (S, 2) f32;
    nrminv, bias: (n,) f32.  On a CUDA tensor this makes one kernel launch
    on the current stream, without synchronizing (padding P's columns to
    whole 16-byte chunks first if they are not): packed rows of at most
    32 KB stream through the TMA ring kernel in tiles of whole rows, wider
    rows, up to the entry point's 1 MiB, through the wide-row kernel of the
    same source, in groups of 8 rows walked in 4 KB pieces.  On
    a CPU tensor it runs :func:`packed_select_ref`.
    """
    global launches
    _check(P, dirs2, nrminv, bias)
    if P.device.type == "cpu":
        return packed_select_ref(P, dirs2, nrminv, bias)
    if P.device.type != "cuda":
        raise ValueError(f"packed_select runs on CPU or CUDA tensors, not {P.device}")
    Pp = padded(P)
    dirs2 = dirs2.contiguous()
    dev = P.device
    idx = torch.empty(1, dtype=torch.int32, device=dev)
    score = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _cuda_build.load_library()
    with torch.cuda.device(dev):
        ws, stream = workspace(dev)
        err = lib.packed_select_launch(
            ctypes.c_void_p(Pp.data_ptr()), Pp.shape[0], Pp.shape[1],
            ctypes.c_void_p(dirs2.data_ptr()), dirs2.shape[0],
            *(ctypes.c_void_p(t.data_ptr()) for t in (nrminv, bias, ws, idx, score)),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"packed_select kernel launch failed: CUDA error {err}")
    launches += 1
    return idx[0], score[0]
