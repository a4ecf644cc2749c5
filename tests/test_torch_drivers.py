"""The experiment drivers' configurations that ``tests/test_torch_experiments.py``
does not hold against the JAX package, held here on the CPU: the Gaussian
experiment's GIGA-REAL-EXACT and its sampled algorithms, and the rest of
``linear_regression``'s algorithms (``logistic_poisson --model poiss``:
``tests/test_torch_drivers_poisson.py``; the logistic GIGA-REAL and US
arms: ``tests/test_torch_drivers_logistic.py``).

Each test feeds the same argv, and the same numpy data injected into both
packages, to the JAX driver and to the port's ``run --device cpu``
(``test_torch_experiments._both``).  Tolerances:
- deterministic builds (GIGA-REAL-EXACT on the same data and the same
  realistic subsample; the exact families' SparseVI, which draws nothing;
  US, which draws its atoms with numpy from the trial in both packages):
  the same sizes, and metrics within ``KL_TOL``;
- sampled algorithms: the same result columns, every metric finite, rKL
  at the largest size below the first size's (not for BatchPSVI, which
  rebuilds at each size), and the port's final rKL within ``RKL_SLACK``
  of JAX's on the same data (PERF.md §2's rule, as
  ``test_gaussian_giga_opt_rkl_within_jax_rule``), on the median of
  several trials where one trial's rKL moves by more than that.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.experiments import gaussian as JG
from bayesian_coresets_tpu.experiments import linear_regression as JLR
from bayesian_coresets_tpu_torch.experiments import gaussian as TG
from bayesian_coresets_tpu_torch.experiments import linear_regression as TLR
from test_torch_experiments import (FKL_RTOL, G_FLAGS, KL_TOL, LR_FLAGS, TIMING, _both, _col,
                                    gaussian_x, workdir)  # noqa: F401

torch.set_num_threads(1)

RKL_SLACK = 1.5
METRICS = ("rklw", "fklw", "mu_errs", "Sig_errs")


def _finite(table, keys=METRICS + ("csizes",)):
    for k in keys:
        assert np.isfinite(_col(table, k)).all(), (k, table[k])


def _same_columns(jt, tt):
    assert set(tt.columns) - TIMING == set(jt.columns) - TIMING


# ----------------------------------------------------------------- gaussian

@pytest.fixture
def gaussian_sub(gaussian_x, monkeypatch):
    """``gaussian_x``'s data and one realistic subsample, drawn with numpy,
    in both packages' Gaussian driver (JAX draws it with
    ``jax.random.randint``, the port with ``realistic_subsample``)."""
    N = gaussian_x.shape[0]
    idx = np.random.default_rng(6).integers(0, N, int(np.sqrt(N)))
    randint = jax.random.randint

    def jax_randint(key, shape, minval, maxval, *a, **kw):
        if tuple(shape) == idx.shape and (minval, maxval) == (0, N):
            return jnp.asarray(idx, jnp.int32)
        return randint(key, shape, minval, maxval, *a, **kw)

    monkeypatch.setattr(jax.random, "randint", jax_randint)
    monkeypatch.setattr(TG, "realistic_subsample", lambda gen, n: torch.as_tensor(idx))
    return idx


def test_gaussian_giga_real_exact_matches_jax(gaussian_sub, workdir):
    """GIGA-REAL-EXACT: the exact family refit on the same subsample of the
    same data, so both packages build the same coreset."""
    jt, tt, _ = _both(JG.main, TG.main, {**G_FLAGS, "alg": "GIGA-REAL-EXACT"})
    _same_columns(jt, tt)
    np.testing.assert_array_equal(_col(jt, "csizes"), _col(tt, "csizes"))
    for k in METRICS:
        np.testing.assert_allclose(_col(tt, k), _col(jt, k), err_msg=k, **KL_TOL)
    assert _col(tt, "rklw")[-1] < _col(tt, "rklw")[0]


@pytest.mark.parametrize("alg", ["SVI", "SVI-EXACT", "GIGA-REAL", "US", "BPSVI"])
def test_gaussian_sampled_algorithms_match_jax(alg, gaussian_sub, workdir):
    """The Gaussian experiment's other algorithms in both packages on the
    same data and subsample: the same columns, finite metrics, rKL falling
    with M (not BatchPSVI, which rebuilds at each size), and the port's
    rKL at M_max within RKL_SLACK of JAX's.  SparseVI's exact family draws
    nothing: the same sizes too.  US draws its atoms with numpy from the
    trial in both packages: the same sizes, and the metrics within KL_TOL."""
    jt, tt, _ = _both(JG.main, TG.main, {**G_FLAGS, "alg": alg})
    _same_columns(jt, tt)
    _finite(tt)
    _finite(jt)
    rj, rt = _col(jt, "rklw"), _col(tt, "rklw")
    assert (_col(tt, "csizes") <= _col(tt, "Ms")).all()
    if alg != "BPSVI":
        assert rt[-1] < rt[0], rt
    assert rt[-1] <= RKL_SLACK * rj[-1], (rt, rj)
    if alg in ("SVI-EXACT", "US"):
        np.testing.assert_array_equal(_col(jt, "csizes"), _col(tt, "csizes"))
    if alg == "US":
        for k in METRICS:
            np.testing.assert_allclose(_col(tt, k), _col(jt, k), err_msg=k, **KL_TOL)


# ----------------------------------------------------------------- linear_regression

def test_linear_regression_svi_exact_matches_jax(workdir):
    """SparseVI with the exact family draws nothing: both packages select
    the same atoms, and the metrics agree within KL_TOL (the low-rank
    refits of its 25 slots are f64 in the port, f32 in JAX, ROADMAP Queue
    3 (i); 2.1e-4 relative at most on a CPU)."""
    jt, tt, _ = _both(JLR.main, TLR.main, {**LR_FLAGS, "alg": "SVI-EXACT"})
    _same_columns(jt, tt)
    _finite(tt)
    np.testing.assert_array_equal(_col(jt, "csizes"), _col(tt, "csizes"))
    for k in METRICS:
        np.testing.assert_allclose(_col(tt, k), _col(jt, k), err_msg=k, **KL_TOL)
    assert _col(tt, "rklw")[-1] < _col(tt, "rklw")[0]


# The Hilbert builds' final rKL at LR_FLAGS moves up to 36x between trials
# in either package (30 projection samples of a 31-dimensional posterior;
# trials 1-8 on a CPU, GIGA-REAL: JAX 6.3e3-2.3e5, the port 1.1e4-9.8e4;
# trials 1-6, GIGA-OPT: the port's 0.11-2.0 of JAX's), so one trial's ratio
# says nothing: the rule holds the median over LR_MEDIAN_TRIALS trials
LR_MEDIAN_TRIALS = (1, 2, 3, 4)


def _hold_median_rkl(alg):
    """``alg`` on the same data, bases and realistic subsample in both
    packages, trial by trial: the same columns, finite metrics, rKL falling
    with M in every trial, and the port's median final rKL within
    RKL_SLACK of JAX's."""
    last = {"jax": [], "torch": []}
    for trial in LR_MEDIAN_TRIALS:
        os.makedirs(str(trial))
        os.chdir(str(trial))
        jt, tt, _ = _both(JLR.main, TLR.main, {**LR_FLAGS, "alg": alg, "trial": trial})
        os.chdir("..")
        _same_columns(jt, tt)
        _finite(tt)
        rt = _col(tt, "rklw")
        assert rt[-1] < rt[0], (trial, rt)
        last["jax"].append(_col(jt, "rklw")[-1])
        last["torch"].append(rt[-1])
    assert np.median(last["torch"]) <= RKL_SLACK * np.median(last["jax"]), last


@pytest.mark.parametrize("alg", ["SVI", "GIGA-OPT", "US"])
def test_linear_regression_sampled_algorithms_match_jax(alg, workdir):
    """The same data, bases and realistic subsample (numpy, from the trial)
    in both packages.  GIGA-OPT: ``_hold_median_rkl``.  Black-box SparseVI
    (the samplers' draws differ): the same columns, finite metrics, rKL
    falling with M, and the port's final rKL within RKL_SLACK of JAX's
    (trials 1-6 on a CPU: 0.40-1.02 of it).  US draws its atoms with numpy
    from the trial in both packages (``UniformSamplingCoreset``'s
    ``default_rng(seed)``): the same sizes, and the metrics held as the
    exact families' (KL_TOL; the forward KL within FKL_RTOL, as
    ``test_linear_regression_exact_matches_jax``)."""
    if alg == "GIGA-OPT":
        return _hold_median_rkl(alg)
    jt, tt, _ = _both(JLR.main, TLR.main, {**LR_FLAGS, "alg": alg})
    _same_columns(jt, tt)
    _finite(tt)
    rj, rt = _col(jt, "rklw"), _col(tt, "rklw")
    assert rt[-1] < rt[0], rt
    if alg == "SVI":
        assert rt[-1] <= RKL_SLACK * rj[-1], (rt, rj)
        return
    np.testing.assert_array_equal(_col(jt, "csizes"), _col(tt, "csizes"))
    for k in ("rklw", "mu_errs", "Sig_errs"):
        np.testing.assert_allclose(_col(tt, k), _col(jt, k), err_msg=k, **KL_TOL)
    np.testing.assert_allclose(_col(tt, "fklw"), _col(jt, "fklw"), rtol=FKL_RTOL)


def test_linear_regression_giga_real_matches_jax(workdir):
    """GIGA-REAL: ``_hold_median_rkl``."""
    _hold_median_rkl("GIGA-REAL")
