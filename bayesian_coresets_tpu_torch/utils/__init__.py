"""Utilities: tolerances, logging, errors, checkpoints, phase timing, and
interop with the JAX package."""

from . import checkpoint, profiling
from .config import (
    TOL,
    default_device,
    default_dtype,
    get_tolerance,
    set_default_device,
    set_tolerance,
)
from .errors import NumericalPrecisionError
from .log import get_logger, set_verbosity

__all__ = [
    "checkpoint",
    "profiling",
    "TOL",
    "get_tolerance",
    "set_tolerance",
    "default_dtype",
    "default_device",
    "set_default_device",
    "NumericalPrecisionError",
    "get_logger",
    "set_verbosity",
]
