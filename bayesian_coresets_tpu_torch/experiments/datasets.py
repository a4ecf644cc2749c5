"""Dataset loading/preparation for the regression experiments.

Port of ``bayesian_coresets_tpu/experiments/datasets.py`` (NumPy only;
reference per-model ``load_data``, model_lr.py:3-13, model_poiss.py:4-17):
load an .npz with X/y (+Xt/yt for Poisson), whiten the covariates with the
Cholesky factor of their covariance (intercept column untouched), and
build the folded/augmented data matrices.

Datasets (synth_lr, phishing, ds1, synth_poiss, biketrips, airportdelays)
are read from the directory that ``BC_DATA_DIR`` names when the call is
made (the reference's ``examples/data``, say), else from ``data/`` at the
root of the repository.  None is shipped, and nothing is fetched.
"""

from __future__ import annotations

import os

import numpy as np

DATA_DIRS = [os.path.join(os.path.dirname(__file__), "..", "..", "data")]


def data_dirs() -> list[str]:
    """Where datasets are looked for, in order: ``BC_DATA_DIR`` (read now),
    then :data:`DATA_DIRS`."""
    env = os.environ.get("BC_DATA_DIR", "")
    return ([env] if env else []) + DATA_DIRS


def _find(name: str) -> str:
    fname = name if name.endswith(".npz") else name + ".npz"
    for d in data_dirs():
        if os.path.exists(os.path.join(d, fname)):
            return os.path.join(d, fname)
    raise FileNotFoundError(f"dataset {name!r} not found in {data_dirs()}")


def _whiten(X, Xt=None):
    """Cholesky-whiten all but the last (intercept) column."""
    m = X[:, :-1].mean(axis=0)
    V = np.cov(X[:, :-1], rowvar=False) + 1e-12 * np.eye(X.shape[1] - 1)
    L = np.linalg.cholesky(V)
    X = X.copy()
    X[:, :-1] = np.linalg.solve(L, (X[:, :-1] - m).T).T
    if Xt is not None:
        Xt = Xt.copy()
        Xt[:, :-1] = np.linalg.solve(L, (Xt[:, :-1] - m).T).T
    return X, Xt


def load_logistic(name: str):
    """Returns (X, Y, Z, None, d) with Z = y[:,None]*X (model_lr.py:3-13)."""
    with np.load(_find(name)) as data:
        X = np.asarray(data["X"], np.float64)
        Y = np.asarray(data["y"], np.float64)
    X, _ = _whiten(X)
    Z = Y[:, None] * X
    return X.astype(np.float32), Y, Z.astype(np.float32), None, Z.shape[1]


def load_poisson(name: str):
    """Returns (X, Y, Z, Zt, d) with Z = [X, y] (model_poiss.py:4-17)."""
    with np.load(_find(name)) as data:
        X = np.asarray(data["X"], np.float64)
        Y = np.asarray(data["y"], np.float64)
        Xt = np.asarray(data["Xt"], np.float64)
        Yt = np.asarray(data["yt"], np.float64)
    X, Xt = _whiten(X, Xt)
    Z = np.hstack((X, Y[:, None]))
    Zt = np.hstack((Xt, Yt[:, None]))
    return (X[:, :-1].astype(np.float32), Y, Z.astype(np.float32),
            Zt.astype(np.float32), Z.shape[1] - 1)


def gen_synthetic_housing(rng, n: int):
    """Synthetic stand-in for the UK housing dataset (prices2018.npy is not
    shipped with the reference): rows [lat, lon, log10-price-like]."""
    locs = rng.uniform(-2.0, 2.0, size=(n, 2))
    centers = rng.uniform(-2.0, 2.0, size=(6, 2))
    amps = rng.uniform(-0.5, 0.5, size=6)
    price = 5.0 + sum(a * np.exp(-((locs - c) ** 2).sum(1) / 0.8)
                      for a, c in zip(amps, centers))
    price += 0.05 * rng.normal(size=n)
    return np.hstack([locs, price[:, None]]).astype(np.float64)
