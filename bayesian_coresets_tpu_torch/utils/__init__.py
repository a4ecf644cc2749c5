"""Utilities: tolerances, logging, errors, and interop with the JAX package."""

from .config import TOL, default_dtype, get_tolerance, set_tolerance
from .errors import NumericalPrecisionError
from .log import get_logger, set_verbosity

__all__ = [
    "TOL",
    "get_tolerance",
    "set_tolerance",
    "default_dtype",
    "NumericalPrecisionError",
    "get_logger",
    "set_verbosity",
]
