"""bayesian_coresets_tpu_torch — the PyTorch/CUDA port of bayesian_coresets_tpu.

A second package beside the JAX one, grown slice by slice and held against
it by tests on identical inputs.  This slice is the Hilbert-GIGA coreset on
logistic regression: data, a Laplace fit, the black-box projection, and
GIGA, whose per-iteration select is a hand-written CUDA kernel on CUDA
tensors (``ops/giga_select.py``, ``csrc/giga_select.cu``).  Tensors stay
on the device they were given; nothing here picks a device.

It imports torch and never JAX or the JAX package.
"""

from . import models, ops, utils
from . import utils as util           # reference spelling: bc.util.set_verbosity
from .ops import snnls                # reference pattern: bc.snnls.GIGA
from .coresets import Coreset, HilbertCoreset
from .coresets.projector import BlackBoxProjector, Projector
from .utils import set_tolerance, set_verbosity

__version__ = "0.1.0"

__all__ = [
    "models",
    "ops",
    "utils",
    "util",
    "snnls",
    "Coreset",
    "HilbertCoreset",
    "Projector",
    "BlackBoxProjector",
    "set_tolerance",
    "set_verbosity",
]
