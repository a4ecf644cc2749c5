"""Models: batched log-densities and gradients, and the Laplace fit."""

from . import gaussian, logistic
from .laplace import LaplaceResult, laplace_approx, sample_laplace

__all__ = ["gaussian", "logistic", "laplace_approx", "sample_laplace", "LaplaceResult"]
