"""Global numeric configuration.

The reference keeps a module-global ``TOL = 1e-12`` with a ``set_tolerance``
mutator (reference: bayesiancoresets/util/__init__.py:4-7).  The user-facing
API is the same; the default is sized for float32 arithmetic, as in the JAX
package (bayesian_coresets_tpu/utils/config.py).

Float32 matrix products run in full float32: TF32 keeps about three decimal
digits, which the projection GEMM and the Laplace Newton solve cannot afford
(the JAX package forces ``highest`` precision for the same reason).
"""

from __future__ import annotations

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


def default_dtype() -> torch.dtype:
    """Compute dtype for solver internals.

    float32: the coreset algorithms are precision-sensitive (geodesic
    directions, error monotonicity), so nothing is downcast below f32.
    """
    return torch.float32
