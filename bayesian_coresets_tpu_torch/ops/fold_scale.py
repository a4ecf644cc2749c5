"""The wscale fold of the GIGA and Frank-Wolfe builds, gated on the device.

Counterpart of the JAX package's ``lax.cond`` in ``_carried_commit``
(``bayesian_coresets_tpu/ops/snnls.py:698``): where ``flag`` (a 0-dim bool
device tensor) is set, every weight is multiplied by ``scale`` (0-dim
f32), in place; otherwise nothing changes.  The build loop reads nothing
back per iteration, so the branch is taken on the device.

:func:`fold_scale` launches the hand-written CUDA kernel
(``csrc/fold_scale.cu``: every block returns at once while the flag is
clear) for CUDA tensors, and runs the plain PyTorch version
:func:`fold_scale_ref` for CPU tensors; there is no other route and no
fallback.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

launches = 0        # kernel launches by fold_scale (plain-version calls not counted)


def fold_scale_ref(w: torch.Tensor, flag: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``w *= scale`` where ``flag``, as one O(n)
    multiply by ``scale`` or by 1.0, which is exact; returns ``w``."""
    return w.mul_(torch.where(flag, scale, 1.0))


def fold_scale(w: torch.Tensor, flag: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``w *= scale`` in place where the 0-dim bool ``flag`` is set; returns
    ``w``.  w: contiguous 1-D f32; flag, scale: 0-dim bool and f32 on w's
    device.  On a CUDA tensor one kernel launch on the current stream,
    without synchronizing; on a CPU tensor :func:`fold_scale_ref`."""
    global launches
    if w.dtype != torch.float32 or w.dim() != 1 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 1-D float32 tensor; got {w.dtype} "
                         f"{tuple(w.shape)}")
    if flag.dtype != torch.bool or flag.dim() != 0 or scale.dtype != torch.float32 \
            or scale.dim() != 0:
        raise ValueError("flag and scale must be 0-dim bool and float32 tensors")
    if flag.device != w.device or scale.device != w.device:
        raise ValueError(f"all inputs must be on {w.device}")
    if w.device.type == "cpu":
        return fold_scale_ref(w, flag, scale)
    if w.device.type != "cuda":
        raise ValueError(f"fold_scale runs on CPU or CUDA tensors, not {w.device}")
    if w.numel() == 0:
        return w
    lib = _cuda_build.load_library()
    with torch.cuda.device(w.device):
        err = lib.fold_scale_launch(
            ctypes.c_void_p(w.data_ptr()), w.shape[0], ctypes.c_void_p(flag.data_ptr()),
            ctypes.c_void_p(scale.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(w.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"fold_scale kernel launch failed: CUDA error {err}")
    launches += 1
    return w
