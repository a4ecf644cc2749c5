"""Global numeric configuration.

The reference keeps a module-global ``TOL = 1e-12`` with a ``set_tolerance``
mutator (reference: bayesiancoresets/util/__init__.py:4-7).  The user-facing
API is the same; the default is sized for float32 arithmetic, as in the JAX
package (bayesian_coresets_tpu/utils/config.py).

Float32 matrix products run in full float32: TF32 keeps about three decimal
digits, which the projection GEMM and the Laplace Newton solve cannot afford
(the JAX package forces ``highest`` precision for the same reason).

The default device is this package's counterpart of the JAX package's
default platform: the entry points put data that is not a tensor yet (numpy
arrays, lists) on :func:`default_device`, the CUDA card unless
:func:`set_default_device` says otherwise.  A tensor stays where the caller
put it.
"""

from __future__ import annotations

import contextlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False

# Relative slack used by error-monotonicity checks; f32 epsilon is ~1.2e-7 so
# 1e-12 (the reference's f64 default) would reject virtually every step.
TOL: float = 1e-6


def set_tolerance(tol: float) -> None:
    """Set the library-wide numerical tolerance (reference util/__init__.py:6-7)."""
    global TOL
    if tol < 0:
        raise ValueError(f"tolerance must be nonnegative, got {tol}")
    TOL = float(tol)


def get_tolerance() -> float:
    return TOL


_default_device: torch.device | None = None


def set_default_device(dev) -> None:
    """Where the entry points put data given as numpy arrays or lists, and
    the generators they make when none is given: ``"cpu"`` to run on the
    CPU; ``None`` restores the default, the CUDA card."""
    global _default_device
    _default_device = None if dev is None else torch.device(dev)


@contextlib.contextmanager
def using_device(dev):
    """:func:`set_default_device` for the block, then the setting found
    before it (what a driver's ``--device`` does for one run)."""
    global _default_device
    prev = _default_device
    set_default_device(dev)
    try:
        yield
    finally:
        _default_device = prev


def resolve_device(dev) -> torch.device:
    """``dev`` with a CUDA device's index filled in (the current one), so
    that it compares equal to the device of the tensors made on it."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_device() -> torch.device:
    """The device set by :func:`set_default_device`, else the CUDA card.
    Raises where there is no card and the CPU was not chosen: nothing falls
    back to the CPU silently."""
    if _default_device is not None:
        return resolve_device(_default_device)
    if torch.cuda.is_available():
        return resolve_device("cuda")
    raise RuntimeError(
        "no CUDA device: call bayesian_coresets_tpu_torch.set_default_device('cpu') "
        "to run on the CPU, or pass CPU tensors")


def as_tensor(x, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """``x`` as an entry point takes it: a tensor stays on its device (the
    caller chose it) unless ``device`` is given; anything else goes to
    ``device``, else to :func:`default_device`."""
    if device is not None:
        return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=default_device())


def on_device(x, dtype: torch.dtype | None, dev: torch.device, what: str) -> torch.Tensor:
    """``x`` on ``dev``, the device of the data it goes with: a tensor on
    another device raises, anything else is placed there."""
    if isinstance(x, torch.Tensor) and x.device != dev:
        raise ValueError(f"{what} is on {x.device} but the data is on {dev}; "
                         "pass both on one device")
    return torch.as_tensor(x, dtype=dtype, device=dev)


def default_dtype() -> torch.dtype:
    """Compute dtype for solver internals.

    float32: the coreset algorithms are precision-sensitive (geodesic
    directions, error monotonicity), so nothing is downcast below f32.
    """
    return torch.float32
