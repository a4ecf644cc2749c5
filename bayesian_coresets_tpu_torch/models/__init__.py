"""Models: batched log-densities and gradients, and the Laplace fit."""

from . import gaussian, linreg, logistic, poisson
from .laplace import LaplaceResult, laplace_approx, sample_laplace

__all__ = ["gaussian", "linreg", "logistic", "poisson", "laplace_approx", "sample_laplace", "LaplaceResult"]
