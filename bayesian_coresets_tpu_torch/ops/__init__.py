"""Numerical kernels: the GIGA solver and its fused select."""

from . import giga_select
from .snnls import (
    GIGA,
    SNNLSConsts,
    SNNLSState,
    SparseNNLS,
    build,
    init_state,
    make_consts,
)

__all__ = [
    "GIGA",
    "SparseNNLS",
    "SNNLSConsts",
    "SNNLSState",
    "build",
    "init_state",
    "make_consts",
    "giga_select",
]
