"""Numerical kernels: the sparse-NNLS solvers (GIGA, Frank-Wolfe, OMP,
importance and uniform sampling), their fused select, the packed-int4
select probe, the active-set NNLS re-solve, and projected Adam; the
solvers also run on int8-resident constants (``make_consts_quantized``).
On a CUDA device the build loop and the re-solve replay CUDA graphs
(``graphs``)."""

from . import giga_select, graphs, nnls, packed_select
from .opt import nn_opt
from .snnls import (
    GIGA,
    FrankWolfe,
    ImportanceSampling,
    OrthoPursuit,
    SNNLSConsts,
    SNNLSState,
    SparseNNLS,
    UniformSampling,
    build,
    init_state,
    make_consts,
    make_consts_quantized,
    optimize_active,
)

__all__ = [
    "GIGA",
    "FrankWolfe",
    "OrthoPursuit",
    "ImportanceSampling",
    "UniformSampling",
    "SparseNNLS",
    "SNNLSConsts",
    "SNNLSState",
    "build",
    "init_state",
    "optimize_active",
    "make_consts",
    "make_consts_quantized",
    "nn_opt",
    "nnls",
    "giga_select",
    "graphs",
    "packed_select",
]
