"""``logistic_poisson --model poiss`` against the JAX package on the CPU
(its SparseVI and BatchPSVI arms: ``tests/test_torch_drivers_poisson_adam.py``;
the logistic GIGA-REAL and US arms: ``tests/test_torch_drivers_logistic.py``;
the other drivers' configurations: ``tests/test_torch_drivers.py``).

The same argv and the same tiny data (``tiny_data.write_poisson``) go to
the JAX driver and to the port's ``run --device cpu``.  Tolerances:
- full-data NUTS, each package in a directory of its own: means within
  0.25 posterior sd of the JAX package's;
- the algorithms, trial by trial in one directory per trial, so that the
  port reads the full-data chains that the JAX run cached there (the same
  cache path in both packages) and the two rKLs differ by the coreset and
  its chains alone: the same result columns, every float column finite,
  nonempty coresets, and the port's median final rKL over TRIALS within
  RKL_SLACK of JAX's (``test_torch_drivers.py``'s rule);
- BatchPSVI moves whole rows, and JAX's Poisson ``grad_z_log_likelihood``
  covers the covariates alone (ROADMAP Queue 3 (m)): JAX runs it here with
  that gradient and a zero column for the count, which is the port's
  ``grad_row_log_likelihood``, held to it elementwise (rtol 1e-5).
"""

import argparse
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.experiments import datasets as jdatasets
from bayesian_coresets_tpu.experiments import logistic_poisson as JLP
from bayesian_coresets_tpu.experiments import results as jres
from bayesian_coresets_tpu.models import logistic as jlogistic
from bayesian_coresets_tpu.models import poisson as jpoisson
from bayesian_coresets_tpu_torch.experiments import logistic_poisson as TLP
from bayesian_coresets_tpu_torch.experiments import results as tres
from bayesian_coresets_tpu_torch.models import logistic as tlogistic
from bayesian_coresets_tpu_torch.models import poisson as tpoisson
from bayesian_coresets_tpu_torch.utils import config
from test_torch_drivers import RKL_SLACK, _same_columns
from test_torch_experiments import LP_FLAGS, TIMING, _argv, _col, workdir  # noqa: F401
from tiny_data import write_poisson

torch.set_num_threads(1)

POISS_FLAGS = {**LP_FLAGS, "model": "poiss", "dataset": "synth_poiss"}
# the algorithms' runs: 256 full-data draws (shared by both packages) and
# 128 on each coreset.  One trial's final rKL moves 0.14-1.8 between trials
# in JAX (GIGA-REAL) and the port's ratio to it 0.22-8.7 (trials 1-6 on a
# CPU), so the rule holds the median over TRIALS: 0.43 (GIGA-REAL), 1.08
# (US), 0.81 (SVI) and 0.60 (BPSVI) of JAX's on a CPU
RUN_FLAGS = {"mcmc_samples_full": 256, "mcmc_samples_coreset": 128, "opt_itrs": 20}
TRIALS = (1, 2, 3)


def _data(folder, monkeypatch):
    """``tiny_data.write_poisson``'s data in both packages' loader."""
    write_poisson(str(folder))
    monkeypatch.setattr(jdatasets, "DATA_DIRS", [str(folder)])
    monkeypatch.setenv("BC_DATA_DIR", str(folder))


GRAD_Z = jpoisson.grad_z_log_likelihood


def _jax_row_gradient(z, th):
    """JAX's Poisson ``grad_z_log_likelihood`` and 0 for the count."""
    g = GRAD_Z(z, th)
    return jnp.concatenate([g, jnp.zeros_like(g[:, :, :1])], axis=2)


def _in(sub, main, flags):
    """``main(flags)`` run in the directory ``sub`` (made if missing)."""
    os.makedirs(sub, exist_ok=True)
    os.chdir(sub)
    try:
        return main(_argv(flags))
    finally:
        os.chdir("..")


def _float_columns_finite(table):
    for k in set(table.columns) - TIMING:
        if table[k].dtype.kind == "f":
            assert np.isfinite(table[k]).all(), k


def trial_runs(flags, algs):
    """Each of TRIALS in a directory of its own under the current one: for
    each of ``algs``, the JAX driver into results_jax/, then the port's
    ``run --device cpu`` into results_torch/ on the full-data chains that
    the JAX run cached.  Returns {alg: {"jax": [table per trial], "torch":
    [...], "coreset": [the port's coreset per trial]}}."""
    out = {alg: {"jax": [], "torch": [], "coreset": []} for alg in algs}
    for trial in TRIALS:
        os.makedirs(str(trial))
        os.chdir(str(trial))
        try:
            for alg in algs:
                f = {**flags, "alg": alg, "trial": trial}
                JLP.main(_argv({**f, "results_folder": "results_jax/"}))
                info = TLP.main(_argv({**f, "results_folder": "results_torch/", "device": "cpu"}))
                out[alg]["jax"].append(jres.load_matching({"alg": alg}, folder="results_jax/"))
                out[alg]["torch"].append(tres.load_matching({"alg": alg},
                                                            folder="results_torch/"))
                out[alg]["coreset"].append(info["coreset"])
        finally:
            os.chdir("..")
    assert config._default_device is None
    return out


def hold_trials(runs, same_sizes=False):
    """``trial_runs``' tables of one algorithm: the same columns, every
    float column finite, nonempty coresets (the same sizes where both
    packages draw the same atoms), and the port's median final rKL within
    RKL_SLACK of JAX's."""
    last = {"jax": [], "torch": []}
    for jt, tt in zip(runs["jax"], runs["torch"]):
        _same_columns(jt, tt)
        _float_columns_finite(tt)
        assert (_col(tt, "csizes") > 0).all()
        if same_sizes:
            np.testing.assert_array_equal(_col(jt, "csizes"), _col(tt, "csizes"))
        last["jax"].append(_col(jt, "rklw")[-1])
        last["torch"].append(_col(tt, "rklw")[-1])
    assert np.median(last["torch"]) <= RKL_SLACK * np.median(last["jax"]), last


def test_poisson_full_data_posterior_matches_jax(workdir, monkeypatch):
    """``--model poiss`` through both packages' loader: full-data NUTS means
    within 0.25 posterior sd of JAX's, the same columns, every float column
    finite."""
    _data(workdir / "data", monkeypatch)
    flags = {**POISS_FLAGS, "mcmc_samples_full": 512, "mcmc_chains": 4,
             "coreset_num_sizes": 1}
    _in("jax", JLP.main, flags)
    _in("torch", TLP.main, {**flags, "device": "cpu"})
    path = TLP.full_cache_path(argparse.Namespace(**flags, target_accept=0.9))
    with np.load(os.path.join("jax", path)) as fj, np.load(os.path.join("torch", path)) as ft:
        sj, st = fj["samples"], ft["samples"]
        assert st.shape == sj.shape == (512, 3)
        assert float(ft["ess"]) > 50 and float(ft["rhat"]) < 1.1
    sd = sj.std(axis=0)
    assert (np.abs(st.mean(axis=0) - sj.mean(axis=0)) < 0.25 * sd).all(), \
        (st.mean(axis=0), sj.mean(axis=0), sd)
    tt = tres.load_matching({}, folder="torch/results/")
    jt = jres.load_matching({}, folder="jax/results/")
    _same_columns(jt, tt)
    _float_columns_finite(tt)


@pytest.mark.parametrize("model", ["poisson", "logistic"])
def test_row_gradient_matches_jax(model):
    """The gradient that the port's driver hands BatchPSVI, with respect to
    the whole row, against JAX's on the same rows and samples, elementwise
    (rtol 1e-5, atol 1e-6; f32): for Poisson, JAX's covariate gradient and
    0 for the count; for logistic the row is the (folded) datapoint, JAX's
    ``grad_z_log_likelihood`` itself."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 3))
    z = (np.hstack([x, rng.poisson(2.0, size=(40, 1))]) if model == "poisson" else x)
    th = rng.normal(size=(7, 3))
    z, th = z.astype(np.float32), th.astype(np.float32)
    tmod = tpoisson if model == "poisson" else tlogistic
    want = (_jax_row_gradient if model == "poisson" else jlogistic.grad_z_log_likelihood)(
        jnp.asarray(z), jnp.asarray(th))
    got = tmod.grad_row_log_likelihood(torch.as_tensor(z), torch.as_tensor(th))
    assert got.shape == want.shape == (40, 7, z.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def poisson_runs(tmp_path_factory):
    """GIGA-REAL and US through ``trial_runs`` on the tiny Poisson data."""
    return poisson_trial_runs(tmp_path_factory, ("GIGA-REAL", "US"))


def poisson_trial_runs(tmp_path_factory, algs):
    """``algs`` through ``trial_runs`` on the tiny Poisson data; JAX's
    BatchPSVI with the whole row's gradient."""
    tmp = tmp_path_factory.mktemp("poisson")
    with pytest.MonkeyPatch.context() as mp:
        _data(tmp / "data", mp)
        mp.setattr(jpoisson, "grad_z_log_likelihood", _jax_row_gradient)
        mp.chdir(tmp)
        return trial_runs({**POISS_FLAGS, **RUN_FLAGS}, algs)


@pytest.mark.parametrize("alg", ["GIGA-REAL", "US"])
def test_poisson_algorithms_run(alg, poisson_runs):
    """The port's ``--model poiss`` Hilbert and uniform arms against JAX's
    (SparseVI and BatchPSVI: ``tests/test_torch_drivers_poisson_adam.py``)."""
    hold_poisson(poisson_runs[alg], alg)


def hold_poisson(runs, alg):
    """``hold_trials`` (US draws its atoms with numpy from the trial in
    both packages, so the same sizes), and finite nonnegative weights."""
    hold_trials(runs, same_sizes=alg == "US")
    for c in runs["coreset"]:
        w, _, _ = c.get()
        assert np.isfinite(w).all() and (w >= 0).all()


def test_poisson_bpsvi_moves_covariates_and_keeps_counts(workdir, monkeypatch):
    """ROADMAP Queue 3 (m): BatchPSVI moves whole rows z = [x, y], and the
    Poisson model's ``grad_z_log_likelihood`` covers x alone, so JAX's
    ``--model poiss --alg BPSVI`` raises at its first Adam step.  The port
    passes the whole row's gradient (``poisson.grad_row_log_likelihood``,
    0 for the count): the pseudo-points' covariates move and each keeps
    the count of the data row it started from."""
    _data(workdir / "data", monkeypatch)
    flags = {**POISS_FLAGS, "alg": "BPSVI", "opt_itrs": 20}
    with pytest.raises(TypeError, match="incompatible shapes"):
        _in("jax", JLP.main, flags)
    info = _in("torch", TLP.main, {**flags, "device": "cpu"})
    c = info["coreset"]
    with np.load(workdir / "data" / "synth_poiss.npz") as f:
        counts = f["y"]
    pts = np.asarray(c.pts)
    assert pts.shape == (LP_FLAGS["coreset_size_max"], 4)
    assert np.isin(pts[:, -1], counts).all()
    data = c.data.numpy()
    moved = ~(pts[:, None, :-1] == data[None, :, :-1]).all(-1).any(1)
    assert moved.all(), pts
