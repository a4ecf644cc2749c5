"""Minimal end-to-end tutorial: logistic-regression Hilbert coreset.

Port of ``bayesian_coresets_tpu/experiments/simple_lr.py`` (reference
``examples/simple_lr/main.py``): synthesize LR data, fit a Laplace
approximation at the MAP for the projection tangent space, build a GIGA
Hilbert coreset, refit Laplace on the weighted coreset, and report
KL(coreset posterior || full posterior).  It computes on the default
device (the CUDA card), or on ``device``; the data is drawn there from a
generator seeded by ``seed``, so it differs from the JAX package's draw.

Run: python -m bayesian_coresets_tpu_torch.experiments.simple_lr
"""

from __future__ import annotations

import numpy as np
import torch

from .. import coresets as bc
from ..models import logistic
from ..models.gaussian import kl_divergence
from ..models.laplace import laplace_approx, sample_laplace
from ..utils import config, prng


def main(N: int = 10000, D: int = 10, projection_dim: int = 500, M: int = 500,
         seed: int = 1, verbose: bool = True, device=None):
    def log(*a):
        if verbose:
            print(*a)

    dev = config.resolve_device(device) if device is not None else config.default_device()

    log("Generating data...")
    Z = logistic.gen_synthetic(prng.fold_seed(seed, 0, device=dev), N, D)

    log("Finding MAP for tangent space approximation...")
    ones = torch.ones(N, device=dev)
    lap = laplace_approx(Z, ones, torch.zeros(D, device=dev),
                         grad_fn=logistic.grad_th_log_joint,
                         hess_fn=logistic.hess_th_log_joint)

    log("Building the coreset...")
    sampler = lambda gen, sz, w, p: sample_laplace(gen, lap, sz)
    projector = bc.BlackBoxProjector(sampler, projection_dim, logistic.log_likelihood,
                                     generator=prng.fold_seed(seed, 1, device=dev))
    coreset = bc.HilbertCoreset(Z, projector)
    coreset.build(M)
    wts, pts, idcs = coreset.get()
    log(f"coreset size: {idcs.shape[0]}")

    log("Evaluating coreset quality...")
    # both evaluation fits in f64: GIGA puts up to ~1e8 of weight on one atom
    # here, and in f32 the weighted Hessian's rounding then outgrows the
    # prior's unit curvature, so its Cholesky fails (ROADMAP Queue 3 (k))
    Z64 = Z.double()

    def fit(w):
        return laplace_approx(Z64, w, torch.zeros(D, dtype=torch.float64, device=dev),
                              grad_fn=logistic.grad_th_log_joint,
                              hess_fn=logistic.hess_th_log_joint)

    w_full = np.zeros(N)
    w_full[idcs] = wts
    lap_full, lap_w = fit(ones.double()), fit(torch.as_tensor(w_full, device=dev))
    kl = float(kl_divergence(lap_w.mu, lap_w.USig @ lap_w.USig.T, lap_full.mu,
                             lap_full.LSigInv @ lap_full.LSigInv.T))
    log(f"Posterior requires {N} data")
    log(f"Coreset requires {idcs.shape[0]} data")
    log(f"KL(coreset || posterior) = {kl}")
    return kl, coreset


if __name__ == "__main__":
    main()
