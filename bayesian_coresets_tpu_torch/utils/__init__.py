"""Utilities: tolerances, the default device, logging, errors, checkpoints,
spans and phase timing, seeded generators, and interop with the JAX package."""

from . import checkpoint, profiling, prng
from .config import (
    TOL,
    default_device,
    default_dtype,
    get_tolerance,
    set_default_device,
    set_tolerance,
    using_device,
)
from .errors import NumericalPrecisionError
from .log import get_logger, set_verbosity

__all__ = [
    "checkpoint",
    "profiling",
    "prng",
    "TOL",
    "get_tolerance",
    "set_tolerance",
    "default_dtype",
    "default_device",
    "set_default_device",
    "using_device",
    "NumericalPrecisionError",
    "get_logger",
    "set_verbosity",
]
