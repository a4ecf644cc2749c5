"""The GIGA select: fused scores + global first-max argmax over every row.

Counterpart of ``bayesian_coresets_tpu/ops/pallas_kernels.py``.  Each GIGA
iteration scores every candidate row of the (n, Sp) selection copy against
the two unit directions [cdir_n, xw_n] and takes the first maximum:

    (d0, d1) = Vsel[r] . dirs      int8: int32 dots * f32(1/127^2)
                                    bf16/f32: f32 dots / norms[r]
    score = geo_ok ? d0 / sqrt(max(1 - d1^2, 1e-30)) : 0   (-inf if invalid)

:func:`giga_select` launches the hand-written CUDA kernel
(``csrc/giga_select.cu``) for CUDA tensors, one launch per select and no
other kernel (the kernel quantizes the directions itself and resets its
own workspace; rows of any width up to 1 MiB), and uses the plain PyTorch version :func:`giga_select_ref`
for CPU tensors; there is no other route and no fallback.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

launches = 0   # kernel launches by giga_select (plain-version calls not counted)

_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

_workspaces: dict[tuple[int, int], torch.Tensor] = {}

_REF_BLOCK_ROWS = 1 << 20    # rows per block of the plain version


def workspace(dev: torch.device) -> tuple[torch.Tensor, int]:
    """The select kernels' finish state (16 bytes: the argmax key and a
    ticket) for ``dev``'s current stream, and that stream's handle.

    One per (device, stream), zeroed once when first used; every launch
    leaves it zero again, so calls on one stream reuse it without a reset
    and calls on two streams never share one."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None:      # setdefault: two threads never get two workspaces
        ws = _workspaces.setdefault(key, torch.zeros(2, dtype=torch.int64, device=dev))
    return ws, stream


def col_multiple(dtype: torch.dtype) -> int:
    """Column multiple that makes each row of a ``dtype`` selection copy a
    whole number of the kernel's 16-byte loads."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def quantize_dirs(dirs: torch.Tensor, Sp: int, dtype: torch.dtype) -> torch.Tensor:
    """(S, 2) f32 directions -> (2, Sp) in the selection copy's dtype,
    zero-padded.  int8: round(127 d), half to even, clipped to ±127
    (ops/snnls.py:480 of the JAX package).  The plain version's helper: the
    kernel quantizes the directions itself, bit for bit the same."""
    d = torch.nn.functional.pad(dirs.T, (0, Sp - dirs.shape[0]))
    if dtype == torch.int8:
        return torch.clamp(torch.round(d * 127.0), -127, 127).to(torch.int8).contiguous()
    return d.to(dtype).contiguous()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, on every device.

    ``torch.sqrt`` on a CPU f32 tensor is not always correctly rounded (it
    differs from CUDA's, and from the kernel's ``__fsqrt_rn``, in the last
    bit); the f64 root rounded to f32 is."""
    return torch.sqrt(x.double()).float()


def score_rows(dots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n, 2) normalized dots -> (n,) GIGA scores (giga.py:33-37)."""
    d1 = dots[:, 1]
    geo_ok = (d1 > -1.0 + 1e-14) & (1.0 - d1 * d1 > 0.0)
    denom = sqrt_rn(torch.clamp(1.0 - d1 * d1, min=1e-30))
    score = torch.where(geo_ok, dots[:, 0] / denom, 0.0)
    return torch.where(valid, score, float("-inf"))


def giga_select_ref(Vsel: torch.Tensor, dirs: torch.Tensor, norms: torch.Tensor,
                    valid: torch.Tensor):
    """Plain PyTorch select: (int32 index, f32 score), 0-dim tensors.

    int8 dots are taken in float64, which is exact for these integer sums
    (an int8 ``@`` on the CPU returns int8 and overflows).  Rows go in
    blocks of ``_REF_BLOCK_ROWS`` (the f64 copy of a 2^20-row int8 block of
    512 columns is 4.3 GB; of an 8M-row matrix it would be 33 GB), and the
    first maximum over the blocks is the global first maximum."""
    q = quantize_dirs(dirs, Vsel.shape[1], Vsel.dtype)
    best_f = best_s = None
    for r in range(0, Vsel.shape[0], _REF_BLOCK_ROWS):
        V, nr = Vsel[r:r + _REF_BLOCK_ROWS], norms[r:r + _REF_BLOCK_ROWS]
        if V.dtype == torch.int8:
            dots = (V.double() @ q.double().T).float() * (1.0 / (127.0 * 127.0))
        else:
            dots = (V.float() @ q.float().T) / nr[:, None]
        score = score_rows(dots, valid[r:r + _REF_BLOCK_ROWS])
        f = torch.argmax(score)
        s, f = score[f], (f + r).to(torch.int32)
        if best_f is None:
            best_f, best_s = f, s
        else:                          # a later block wins only with a larger score
            later = s > best_s
            best_f, best_s = torch.where(later, f, best_f), torch.where(later, s, best_s)
    return best_f, best_s


def _check(Vsel, dirs, norms, valid):
    if Vsel.dim() != 2 or Vsel.dtype not in _DTYPE_CODE or not Vsel.is_contiguous():
        raise ValueError("Vsel must be a contiguous 2-D int8, bfloat16 or float32 "
                         f"tensor; got {Vsel.dtype} {tuple(Vsel.shape)}")
    n, Sp = Vsel.shape
    if not 0 < n < 2**31:
        raise ValueError(f"row count {n} outside (0, 2^31)")
    if (Sp * Vsel.element_size()) % 16 or Vsel.data_ptr() % 16:
        raise ValueError("Vsel rows must be whole 16-byte chunks, 16-byte aligned "
                         f"(pad columns to a multiple of {col_multiple(Vsel.dtype)})")
    if dirs.dtype != torch.float32 or dirs.dim() != 2 or dirs.shape[1] != 2 \
            or dirs.shape[0] > Sp:
        raise ValueError(f"dirs must be float32 (S<= {Sp}, 2); got {dirs.dtype} "
                         f"{tuple(dirs.shape)}")
    if norms.dtype != torch.float32 or tuple(norms.shape) != (n,) or not norms.is_contiguous():
        raise ValueError("norms must be a contiguous float32 (n,) tensor")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,) or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool (n,) tensor")
    for t in (dirs, norms, valid):
        if t.device != Vsel.device:
            raise ValueError(f"all inputs must be on {Vsel.device}; got {t.device}")


def giga_select(Vsel: torch.Tensor, dirs: torch.Tensor, norms: torch.Tensor,
                valid: torch.Tensor):
    """Fused GIGA select: (int32 index, f32 score) as 0-dim device tensors.

    Vsel: (n, Sp) int8 (pre-normalized, ±127), bfloat16 or float32, rows a
    whole number of 16-byte chunks; dirs: (S, 2) f32 [cdir_n, xw_n] with
    S <= Sp; norms: (n,) f32 row norms (unused for int8); valid: (n,) bool.
    On a CUDA tensor this makes one kernel launch on the current stream,
    without synchronizing: rows of at most 48 KB (f32 S <= 12288, bf16
    S <= 24576, int8 S <= 49152) stream through the TMA ring kernel in
    tiles of whole rows, wider rows, up to the entry point's 1 MiB, through
    the wide-row kernel of the same source, in groups of 8 rows walked in
    4 KB pieces.  On a CPU tensor it runs :func:`giga_select_ref`.
    """
    global launches
    _check(Vsel, dirs, norms, valid)
    if Vsel.device.type == "cpu":
        return giga_select_ref(Vsel, dirs, norms, valid)
    if Vsel.device.type != "cuda":
        raise ValueError(f"giga_select runs on CPU or CUDA tensors, not {Vsel.device}")
    n, Sp = Vsel.shape
    row_bytes = Sp * Vsel.element_size()
    dirs = dirs.contiguous()
    dev = Vsel.device
    idx = torch.empty(1, dtype=torch.int32, device=dev)
    score = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _cuda_build.load_library()
    with torch.cuda.device(dev):
        ws, stream = workspace(dev)
        err = lib.giga_select_launch(
            ctypes.c_void_p(Vsel.data_ptr()), _DTYPE_CODE[Vsel.dtype], n, row_bytes,
            ctypes.c_void_p(dirs.data_ptr()), dirs.shape[0],
            ctypes.c_void_p(norms.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
            ctypes.c_void_p(ws.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(score.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"giga_select kernel launch failed: CUDA error {err}")
    launches += 1
    return idx[0], score[0]
