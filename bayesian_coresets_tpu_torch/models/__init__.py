"""Models: batched log-densities and gradients, and the Laplace fit."""

from . import logistic
from .laplace import LaplaceResult, laplace_approx, sample_laplace

__all__ = ["logistic", "laplace_approx", "sample_laplace", "LaplaceResult"]
