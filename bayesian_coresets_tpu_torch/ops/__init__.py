"""Numerical kernels: the GIGA solver, its fused select, and the packed-int4
select probe."""

from . import giga_select, packed_select
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
    "packed_select",
]
