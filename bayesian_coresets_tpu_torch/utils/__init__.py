"""Utilities: tolerances, logging, errors, and interop with the JAX package."""

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
