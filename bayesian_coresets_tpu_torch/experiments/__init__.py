"""Experiment drivers and support libs (reference L3/L4 layers, SURVEY.md §1).

Port of ``bayesian_coresets_tpu/experiments``: the same drivers, argparse
run/plot CLIs and results files, computing on the CUDA card (``run
--device cpu`` for the CPU).  Nothing here imports pandas; matplotlib is
imported only by the functions that draw.

Drivers (argparse run/plot CLIs, results memoization, quantile plotting):
- gaussian: 8-algorithm synthetic-Gaussian study with closed-form metrics
- linear_regression: RBF-basis regression with exact projectors
- logistic_poisson: real datasets + weighted-NUTS coreset posteriors
- synthetic_vectors: raw snnls solver comparison
- simple_lr: minimal end-to-end tutorial
"""

from . import cli, datasets, plotting, results

__all__ = ["cli", "datasets", "plotting", "results"]
