"""Tiny datasets for the driver tests, written with numpy alone, so that
the card tests (which import no JAX) and the CPU parity tests share them."""

import os

import numpy as np


def write_poisson(folder, n=120, nt=40, d=3, seed=1, name="synth_poiss"):
    """Writes ``folder/name.npz`` as the datasets' Poisson files (X, y, Xt,
    yt): N(0, 1) covariates and the intercept last, counts from the model's
    link, y ~ Poisson(softplus(x . theta)) (models/poisson.py::gen_synthetic),
    theta spreading gen_synthetic's unit slope over the covariates with
    intercept 0.  Returns ``folder``."""
    rng = np.random.default_rng(seed)
    theta = np.append(np.full(d - 1, (d - 1) ** -0.5), 0.0)

    def rows(m):
        X = np.hstack([rng.normal(size=(m, d - 1)), np.ones((m, 1))])
        return X, rng.poisson(np.logaddexp(0.0, X @ theta)).astype(np.float64)

    (X, y), (Xt, yt) = rows(n), rows(nt)
    os.makedirs(folder, exist_ok=True)
    np.savez(os.path.join(folder, f"{name}.npz"), X=X, y=y, Xt=Xt, yt=yt)
    return folder
