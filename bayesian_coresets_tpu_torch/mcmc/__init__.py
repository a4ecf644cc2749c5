"""MCMC: weighted-likelihood NUTS/HMC over chains batched on one device.

Port of ``bayesian_coresets_tpu/mcmc``: the weight vector enters the
log-density directly, chains are a leading batch dimension, gradients come
from autograd, and draws from a ``torch.Generator``.
"""

from .adapt import build_schedule, da_init, da_update, find_reasonable_step_size
from .diagnostics import ess, split_rhat
from .draws import Draws
from .hmc import hmc_kernel
from .integrators import (IntegratorState, kinetic, leapfrog, mass_mul,
                          sample_momentum, value_and_grad)
from .nuts import NUTSInfo, Transitions, nuts_kernel
from .sample import MCMCResult, run_nuts
from .weighted import run, weighted_logdensity

__all__ = [
    "IntegratorState",
    "leapfrog",
    "kinetic",
    "mass_mul",
    "sample_momentum",
    "value_and_grad",
    "Draws",
    "nuts_kernel",
    "NUTSInfo",
    "Transitions",
    "hmc_kernel",
    "run_nuts",
    "MCMCResult",
    "run",
    "weighted_logdensity",
    "ess",
    "split_rhat",
    "find_reasonable_step_size",
    "build_schedule",
    "da_init",
    "da_update",
]
