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

A select whose columns are split over ranks (the proj axis of a sharded
build, ``parallel/coreset.py``) runs in two kernels of the same source:
:func:`giga_dots` streams the rank's columns and writes each row's raw
(d0, d1) (int32 for int8, f32 sums not divided by the norm), the ranks sum
them, and :func:`giga_score_select` scores the summed dots and takes the
first maximum as the fused kernel does.  On an unsplit matrix the two give
:func:`giga_select`'s result bit for bit.  ``dots_launches`` and
``score_launches`` count their launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

launches = 0        # kernel launches by giga_select (plain-version calls not counted)
dots_launches = 0   # by giga_dots
score_launches = 0  # by giga_score_select

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
        score = score_rows(_ref_scale(_ref_dots(V, q), nr), valid[r:r + _REF_BLOCK_ROWS])
        f = torch.argmax(score)
        s, f = score.index_select(0, f.view(1))[0], (f + r).to(torch.int32)
        if best_f is None:
            best_f, best_s = f, s
        else:                          # a later block wins only with a larger score
            later = s > best_s
            best_f, best_s = torch.where(later, f, best_f), torch.where(later, s, best_s)
    return best_f, best_s


def _ref_dots(V: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Raw dots of rows ``V`` with the quantized directions ``q`` (2, Sp):
    int8 in float64 (exact for these integer sums) returned as int32, else
    f32."""
    if V.dtype == torch.int8:
        return (V.double() @ q.double().T).to(torch.int32)
    return V.float() @ q.float().T


def _ref_scale(dots: torch.Tensor, norms: torch.Tensor) -> torch.Tensor:
    """Normalized dots: int32 sums times f32(1/127^2), f32 sums over the
    row's norm."""
    if dots.dtype == torch.int32:
        return dots.float() * (1.0 / (127.0 * 127.0))
    return dots / norms[:, None]


def giga_dots_ref(Vsel: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch dots-only select: (n, 2) raw dots of every row of
    ``Vsel`` with the directions quantized to its type, int32 for int8,
    f32 otherwise, in blocks of ``_REF_BLOCK_ROWS`` rows as
    :func:`giga_select_ref` takes them."""
    q = quantize_dirs(dirs, Vsel.shape[1], Vsel.dtype)
    return torch.cat([_ref_dots(Vsel[r:r + _REF_BLOCK_ROWS], q)
                      for r in range(0, Vsel.shape[0], _REF_BLOCK_ROWS)])


def giga_score_select_ref(dots: torch.Tensor, norms: torch.Tensor, valid: torch.Tensor):
    """Plain PyTorch score and first-max argmax of (n, 2) dots (int32: an
    int8 select's sums; f32: sums not yet divided by the norm): (int32
    index, f32 score), 0-dim tensors."""
    score = score_rows(_ref_scale(dots, norms), valid)
    f = torch.argmax(score)
    return f.to(torch.int32), score.index_select(0, f.view(1))[0]


def _check_rows(Vsel, dirs):
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
    if dirs.device != Vsel.device:
        raise ValueError(f"all inputs must be on {Vsel.device}; got {dirs.device}")


def _check_per_row(n, device, norms, valid):
    if norms.dtype != torch.float32 or tuple(norms.shape) != (n,) or not norms.is_contiguous():
        raise ValueError("norms must be a contiguous float32 (n,) tensor")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,) or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool (n,) tensor")
    for t in (norms, valid):
        if t.device != device:
            raise ValueError(f"all inputs must be on {device}; got {t.device}")


def _check(Vsel, dirs, norms, valid):
    _check_rows(Vsel, dirs)
    _check_per_row(Vsel.shape[0], Vsel.device, norms, valid)


def giga_select(Vsel: torch.Tensor, dirs: torch.Tensor, norms: torch.Tensor,
                valid: torch.Tensor):
    """Fused GIGA select: (int32 index, f32 score) as 0-dim device tensors.

    Vsel: (n, Sp) int8 (pre-normalized, ±127), bfloat16 or float32, rows a
    whole number of 16-byte chunks; dirs: (S, 2) f32 [cdir_n, xw_n] with
    S <= Sp; norms: (n,) f32 row norms (unused for int8); valid: (n,) bool.
    On a CUDA tensor this makes one kernel launch on the current stream,
    without synchronizing: rows of at most 4 KB (f32 S <= 1024, bf16
    S <= 2048; int8 rows of at most 4608 bytes) stream through the TMA ring
    kernel in tiles of whole rows, wider rows, up to the entry point's
    1 MiB, through the wide-row kernel of the same source, in groups of 8
    rows walked in 4 KB pieces.  On a CPU tensor it runs
    :func:`giga_select_ref`.  It selects through :func:`giga_select_into`,
    as the fused GIGA step does (:mod:`.giga_step`): every GIGA select of
    the program goes through that one function.
    """
    idx = torch.empty(1, dtype=torch.int32, device=Vsel.device)
    score = torch.empty(1, dtype=torch.float32, device=Vsel.device)
    giga_select_into(Vsel, dirs, norms, valid, idx, score)
    return idx[0], score[0]


def giga_select_into(Vsel: torch.Tensor, dirs: torch.Tensor, norms: torch.Tensor,
                     valid: torch.Tensor, idx: torch.Tensor, score: torch.Tensor) -> None:
    """:func:`giga_select` writing its (index, score) into ``idx`` and
    ``score``, (1,) int32 and float32 tensors on Vsel's device, so that a
    caller that selects again and again allocates nothing per select."""
    global launches
    _check(Vsel, dirs, norms, valid)
    for t, dtype in ((idx, torch.int32), (score, torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != (1,) or t.device != Vsel.device:
            raise ValueError(f"idx and score must be (1,) int32 and float32 tensors on "
                             f"{Vsel.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if Vsel.device.type == "cpu":
        f, s = giga_select_ref(Vsel, dirs, norms, valid)
        idx.copy_(f.view(1))
        score.copy_(s.view(1))
        return
    if Vsel.device.type != "cuda":
        raise ValueError(f"giga_select runs on CPU or CUDA tensors, not {Vsel.device}")
    n, Sp = Vsel.shape
    row_bytes = Sp * Vsel.element_size()
    dirs = dirs.contiguous()
    dev = Vsel.device
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


def giga_dots(Vsel: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Dots-only select: (n, 2) raw dots of every row of ``Vsel`` with the
    directions, int32 for an int8 copy (exact, so sums over column blocks
    are exact), f32 for bf16/f32 (not divided by the norm).

    Vsel and dirs as for :func:`giga_select` (a rank's column block of the
    selection copy, and its slice of the globally normalized directions).
    On a CUDA tensor this makes one launch of the select's stream in its
    dots-only mode, on the current stream, without synchronizing; on a CPU
    tensor it runs :func:`giga_dots_ref`.
    """
    global dots_launches
    _check_rows(Vsel, dirs)
    if Vsel.device.type == "cpu":
        return giga_dots_ref(Vsel, dirs)
    if Vsel.device.type != "cuda":
        raise ValueError(f"giga_dots runs on CPU or CUDA tensors, not {Vsel.device}")
    n, Sp = Vsel.shape
    dirs = dirs.contiguous()
    dev = Vsel.device
    out = torch.empty((n, 2), dtype=torch.int32 if Vsel.dtype == torch.int8 else torch.float32,
                      device=dev)
    lib = _cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.giga_dots_launch(
            ctypes.c_void_p(Vsel.data_ptr()), _DTYPE_CODE[Vsel.dtype], n,
            Sp * Vsel.element_size(), ctypes.c_void_p(dirs.data_ptr()), dirs.shape[0],
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"giga_dots kernel launch failed: CUDA error {err}")
    dots_launches += 1
    return out


def giga_score_select(dots: torch.Tensor, norms: torch.Tensor, valid: torch.Tensor):
    """Score and first-max argmax of (n, 2) summed dots (:func:`giga_dots`'s
    output, reduced over the ranks that hold the other columns): (int32
    index, f32 score) as 0-dim device tensors, :func:`giga_select`'s result
    on the unsplit matrix.  int32 dots are an int8 select's (scaled by
    1/127^2; ``norms`` unused), f32 dots are divided by ``norms``.  On a
    CUDA tensor one kernel launch on the current stream, through the
    stream's select workspace; on a CPU tensor
    :func:`giga_score_select_ref`."""
    global score_launches
    if dots.dim() != 2 or dots.shape[1] != 2 or dots.dtype not in (torch.int32, torch.float32) \
            or not dots.is_contiguous():
        raise ValueError(f"dots must be a contiguous (n, 2) int32 or float32 tensor; got "
                         f"{dots.dtype} {tuple(dots.shape)}")
    n = dots.shape[0]
    if not 0 < n < 2**31:
        raise ValueError(f"row count {n} outside (0, 2^31)")
    _check_per_row(n, dots.device, norms, valid)
    if dots.device.type == "cpu":
        return giga_score_select_ref(dots, norms, valid)
    if dots.device.type != "cuda":
        raise ValueError(f"giga_score_select runs on CPU or CUDA tensors, not {dots.device}")
    dev = dots.device
    idx = torch.empty(1, dtype=torch.int32, device=dev)
    score = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _cuda_build.load_library()
    with torch.cuda.device(dev):
        ws, stream = workspace(dev)
        err = lib.giga_score_launch(
            ctypes.c_void_p(dots.data_ptr()), int(dots.dtype == torch.int32), n,
            ctypes.c_void_p(norms.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
            ctypes.c_void_p(ws.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(score.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"giga_score_select kernel launch failed: CUDA error {err}")
    score_launches += 1
    return idx[0], score[0]
