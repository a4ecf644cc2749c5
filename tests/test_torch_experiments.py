"""The port's experiment layer (``bayesian_coresets_tpu_torch/experiments``
and ``utils/prng.py``) against the JAX package's, on the CPU.

Each driver test feeds the same argv, or the same numpy data injected into
both packages by monkeypatching their dataset or data generator, to the
JAX driver and to the port's ``run --device cpu``, each in a results
folder of its own.  Timing columns (``cput``, ``cputs``,
``*_time_per_itr``) are never compared.  Tolerances:
- the results store: byte-identical files, and values read across packages
  equal (floats within rtol 1e-12: pandas' parser and Python's round alike
  but for the last bit);
- deterministic builds (synthetic vectors; the exact Gaussian and
  linear-regression families while the support is below the feature
  dimension): the same sizes, errors within rtol 1e-4 and KL and moment
  errors within rtol 2e-3 / atol 1e-5 (the posterior refits factorize with
  other LAPACK routines on each side, in f32), and the linear-regression
  forward KL within rtol 1e-2 (it takes the coreset posterior's precision:
  at 25 atoms the f32 refit alone moves it 0.2-0.3% from the f64 value in
  each package, and the weights' own rounding adds to that);
- sampled algorithms: finite metrics, and GIGA-OPT's final rKL within 1.5x
  of the JAX package's on the same data (PERF.md §2's rule); full-data NUTS
  means within 0.25 posterior sd of the JAX package's.
"""

import argparse
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bayesian_coresets_tpu.experiments import cli as jcli
from bayesian_coresets_tpu.experiments import datasets as jdatasets
from bayesian_coresets_tpu.experiments import gaussian as JG
from bayesian_coresets_tpu.experiments import linear_regression as JLR
from bayesian_coresets_tpu.experiments import logistic_poisson as JLP
from bayesian_coresets_tpu.experiments import results as jres
from bayesian_coresets_tpu.experiments import synthetic_vectors as JSV
from bayesian_coresets_tpu.models import gaussian as jgauss
from bayesian_coresets_tpu_torch.experiments import cli as tcli
from bayesian_coresets_tpu_torch.experiments import datasets as tdatasets
from bayesian_coresets_tpu_torch.experiments import gaussian as TG
from bayesian_coresets_tpu_torch.experiments import linear_regression as TLR
from bayesian_coresets_tpu_torch.experiments import logistic_poisson as TLP
from bayesian_coresets_tpu_torch.experiments import results as tres
from bayesian_coresets_tpu_torch.experiments import synthetic_vectors as TSV
from bayesian_coresets_tpu_torch.models import gaussian as tgauss
from bayesian_coresets_tpu_torch.utils import config, prng

torch.set_num_threads(1)

TIMING = {"cput", "cputs", "full_mcmc_time_per_itr", "mcmc_time_per_itr"}
KL_TOL = dict(rtol=2e-3, atol=1e-5)
FKL_RTOL = 1e-2


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    assert config._default_device is None      # no driver leaves its --device behind


def _argv(flags: dict, *extra):
    return ["run"] + [x for k, v in flags.items() for x in (f"--{k}", str(v))] + list(extra)


def _both(jmain, tmain, flags, *extra):
    """Run the JAX driver into results_jax/ and the port's on the CPU into
    results_torch/; returns (pandas frame, port Table, port's return)."""
    jmain(_argv({**flags, "results_folder": "results_jax/"}, *extra))
    out = tmain(_argv({**flags, "results_folder": "results_torch/", "device": "cpu"}, *extra))
    jt = jres.load_matching({"results_folder": "results_jax/"})
    tt = tres.load_matching({"results_folder": "results_torch/"})
    assert jt is not None and tt is not None
    return jt, tt, out


def _col(table, k):
    return np.asarray(table[k], dtype=float)


# ----------------------------------------------------------------- results

def _ns(**kw):
    ns = argparse.Namespace(alg="GIGA", trial=1, results_folder="results/",
                            verbosity="error", func=None, target_accept=0.9,
                            dense_mass=False, dataset="synth_lr", tiny=1e-5)
    ns.__dict__.update(kw)
    return ns


def _results():
    rng = np.random.default_rng(0)
    return dict(Ms=np.array([1, 2, 4], np.int32), err=np.array([3.0, np.nan, np.inf]),
                f32=rng.normal(size=3).astype(np.float32), flag=np.array([True, False, True]),
                mat=rng.normal(size=(3, 2)), big=np.array([1e16, -0.0, 1e-300]))


def test_hash_namespace_matches_jax_and_ignores_device():
    a = _ns()
    assert tres.hash_namespace(a) == jres.hash_namespace(a)
    assert tres.hash_namespace(_ns(device="cpu")) == jres.hash_namespace(a)
    assert tres.hash_namespace(_ns(trial=2)) != tres.hash_namespace(a)


def test_save_writes_the_jax_packages_files(workdir):
    """The same saves, in the same order, give byte-identical result CSVs
    and manifests (namespaces that differ append column-aligned)."""
    for pkg, sub in ((jres, "j"), (tres, "t")):
        os.makedirs(sub)
        os.chdir(sub)
        pkg.save(_ns(), **_results())
        pkg.save(_ns(extra_field=7, trial=3, alg="FW"), **_results())
        pkg.save(_ns(trial=4, model=None), Ms=np.array([5]))
        os.chdir("..")
    names = sorted(os.listdir("j/results"))
    assert names == sorted(os.listdir("t/results")) and len(names) == 4
    for fn in names:
        with open(os.path.join("j/results", fn)) as fj, open(os.path.join("t/results", fn)) as ft:
            assert fj.read() == ft.read(), fn
    mf = tres.read_csv("t/results/manifest.csv")
    assert mf.nrows == 3 and mf.columns[-3:] == ["hash", "extra_field", "model"]
    assert list(mf["alg"]) == ["GIGA", "FW", "GIGA"]
    np.testing.assert_array_equal(mf["extra_field"], [np.nan, 7.0, np.nan])


def _same_table(df: pd.DataFrame, tt):
    assert list(df.columns) == tt.columns
    assert len(df) == tt.nrows
    for k in tt.columns:
        a, b = df[k].to_numpy(), tt[k]
        if b.dtype.kind in "fiub":
            np.testing.assert_allclose(a.astype(float), b.astype(float), rtol=1e-12,
                                       equal_nan=True, err_msg=k)
        else:
            assert [None if pd.isna(x) else str(x) for x in a] == \
                [None if isinstance(x, float) else str(x) for x in b], k


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_reads_the_others_results(writer, workdir):
    save = (tres if writer == "torch" else jres).save
    for trial in (1, 2):
        save(_ns(trial=trial), **_results())
    save(_ns(trial=3, alg="FW", extra_field=7), **_results())
    for match in ({"alg": "GIGA", "results_folder": "results/"},
                  {"trial": 2, "results_folder": "results/"},
                  {"target_accept": 0.9, "results_folder": "results/"},
                  {"results_folder": "results/"}):
        df = jres.load_matching(match)
        tt = tres.load_matching(match)
        _same_table(df, tt)
    assert tres.load_matching({"alg": "GIGA", "results_folder": "results/"}).nrows == 6
    assert tres.load_matching({"alg": "OMP", "results_folder": "results/"}) is None
    assert tres.load_matching({"results_folder": "nowhere/"}) is None


def test_mismatched_lengths_raise(workdir):
    with pytest.raises(ValueError):
        tres.save(_ns(), Ms=np.array([1, 2]), err=np.array([1.0]))


def test_check_exists_memoizes(workdir):
    args = _ns()
    assert not tres.check_exists(args)
    tres.save(args, Ms=np.array([1, 2, 4]), err=np.array([3.0, 2.0, 1.0]))
    assert tres.check_exists(args) and jres.check_exists(args)
    assert not tres.check_exists(_ns(trial=2))


# ----------------------------------------------------------------- cli, prng

CLI_ARGV = {
    "synthetic_vectors": (JSV, TSV, ["run", "--alg", "OMP", "--data_num", "64", "--trial", "3"]),
    "gaussian": (JG, TG, ["run", "--alg", "BPSVI", "--step_sched", "const:0.1",
                          "--select_dtype", "int8"]),
    "linear_regression": (JLR, TLR, ["run", "--alg", "GIGA-REAL-EXACT", "--proj_dim", "20"]),
    "logistic_poisson": (JLP, TLP, ["run", "--model", "poiss", "--dense_mass",
                                    "--target_accept", "0.8", "--mcmc_chains", "4"]),
}


@pytest.mark.parametrize("name", sorted(CLI_ARGV))
def test_cli_gives_the_jax_namespace_and_hash(name, monkeypatch):
    jmod, tmod, argv = CLI_ARGV[name]
    got = {}
    monkeypatch.setattr(jmod, "run", lambda a: got.setdefault("jax", a))
    monkeypatch.setattr(tmod, "run", lambda a: got.setdefault("torch", a))
    jmod.main(argv)
    tmod.main(argv + ["--device", "cpu"])
    ja, ta = vars(got["jax"]), vars(got["torch"])
    assert ta.pop("device") == "cpu"
    ja.pop("func"), ta.pop("func")
    assert ja == ta
    assert tres.hash_namespace(got["torch"]) == jres.hash_namespace(got["jax"])


def test_step_sched_and_size_grid_match_jax():
    for spec in ("inv", "invsqrt", "const:0.3", "inv:2.5"):
        for i in (0, 1, 7, 100):
            assert tcli.step_sched(spec)(i) == jcli.step_sched(spec)(i)
    with pytest.raises(ValueError):
        tcli.step_sched("lambda i: i")
    for args in [(1000, 7, "log"), (300, 6, "log"), (20, 3, "linear"), (1, 1, "log")]:
        for z in (True, False):
            np.testing.assert_array_equal(tcli.coreset_size_grid(*args, with_zero=z),
                                          jcli.coreset_size_grid(*args, with_zero=z))


def test_prng_same_tags_same_stream_other_tags_other_streams():
    def draw(g):
        return torch.randn(8, generator=g).numpy()
    cpu = torch.device("cpu")
    a = draw(prng.fold_seed(3, 1, 2, device=cpu))
    np.testing.assert_array_equal(a, draw(prng.fold_seed(3, 1, 2, device=cpu)))
    others = [(3, 2, 1), (3, 1), (4, 1, 2), (3, 1, 2, 0)]
    for tags in others:
        assert not np.array_equal(a, draw(prng.fold_seed(*tags, device=cpu))), tags
    kids = prng.split_like(prng.fold_seed(3, device=cpu), 3)
    g = prng.fold_seed(3, device=cpu)
    draw(g)                      # a split depends on the seed, not the state
    again = prng.split_like(g, 3)
    streams = [draw(k) for k in kids]
    for s, t in zip(streams, again):
        np.testing.assert_array_equal(s, draw(t))
    assert len({s.tobytes() for s in streams}) == 3


def test_run_without_a_card_raises_and_device_is_restored(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TSV.main(["run", "--data_num", "16", "--data_dim", "4"])
    assert not os.path.exists("results")
    TSV.main(["run", "--data_num", "16", "--data_dim", "4", "--coreset_size_max", "4",
              "--coreset_num_sizes", "2", "--device", "cpu"])
    assert config._default_device is None


# ----------------------------------------------------------------- drivers

SV_FLAGS = {"data_num": 200, "data_dim": 40, "coreset_size_max": 30,
            "coreset_num_sizes": 6, "trial": 2}


@pytest.mark.parametrize("alg", ["GIGA", "FW", "OMP"])
def test_synthetic_vectors_matches_jax(alg, workdir):
    jt, tt, alg_t = _both(JSV.main, TSV.main, {**SV_FLAGS, "alg": alg})
    np.testing.assert_array_equal(_col(jt, "Ms"), _col(tt, "Ms"))
    np.testing.assert_array_equal(_col(jt, "csize"), _col(tt, "csize"))
    np.testing.assert_allclose(_col(tt, "err"), _col(jt, "err"), rtol=1e-4)
    assert int(alg_t.snnls.state.itr) == int(_col(tt, "Ms")[-1])


def test_synthetic_vectors_uniform_sampling(workdir):
    TSV.main(_argv({**SV_FLAGS, "alg": "US", "device": "cpu"}))
    tt = tres.load_matching({"results_folder": "results/"})
    assert (_col(tt, "csize") <= _col(tt, "Ms")).all() and (_col(tt, "csize") > 0).all()
    assert np.isfinite(_col(tt, "err")).all()


# data_num 1200: the realistic subsample has sqrt(N) = 34 rows, more than the
# 31 bases, so both packages refit its posterior by QR.  At 17 rows
# (N = 300) they take the low-rank refit, whose f32 mean in the JAX package
# is ~3% off the f64 one (ROADMAP Queue 3 (i); the port refits in f64,
# test_linear_regression_lowrank_refit_keeps_the_mean), and their builds part.
LR_FLAGS = {"data_num": 1200, "n_bases_per_scale": 5, "proj_dim": 30,
            "coreset_size_max": 25, "coreset_num_sizes": 4, "trial": 1}


@pytest.mark.parametrize("alg", ["GIGA-OPT-EXACT", "GIGA-REAL-EXACT"])
def test_linear_regression_exact_matches_jax(alg, workdir):
    jt, tt, _ = _both(JLR.main, TLR.main, {**LR_FLAGS, "alg": alg})
    assert _col(tt, "csizes").max() < LR_FLAGS["proj_dim"]
    np.testing.assert_array_equal(_col(jt, "csizes"), _col(tt, "csizes"))
    for k in ("rklw", "mu_errs", "Sig_errs"):
        np.testing.assert_allclose(_col(tt, k), _col(jt, k), err_msg=k, **KL_TOL)
    np.testing.assert_allclose(_col(tt, "fklw"), _col(jt, "fklw"), rtol=FKL_RTOL)
    assert set(tt.columns) - TIMING == set(jt.columns) - TIMING


def test_linear_regression_metrics_are_f64(workdir):
    """ROADMAP Queue 3 (j): at this size the JAX package's f32 metric refits
    give rKL -17.1 and fKL -40.9 at M=200; the port refits in f64, so every
    KL is nonnegative and the last equals the f64 NumPy closed form of the
    coreset it returns."""
    flags = {"alg": "GIGA-OPT-EXACT", "data_num": 4000, "n_bases_per_scale": 30,
             "proj_dim": 60, "coreset_size_max": 200, "coreset_num_sizes": 4, "device": "cpu"}
    coreset = TLR.main(_argv(flags))
    tt = tres.load_matching({}, folder="results/")
    assert (_col(tt, "rklw") >= 0).all() and (_col(tt, "fklw") >= 0).all(), tt

    # the f64 closed form from the same inputs (the driver's own recipe)
    rng = np.random.default_rng(0)
    x = tdatasets.gen_synthetic_housing(rng, flags["data_num"])
    sigsq, mn = x[:, 2].var(), x[:, 2].mean()
    scales = np.repeat([0.2, 0.4, 0.8, 1.2, 1.6, 2.0, 100.0], [30] * 6 + [1])
    locs = np.vstack([x[rng.choice(x.shape[0], replace=False, size=c), :2]
                      for c in [30] * 6 + [1]])
    X = np.exp(-((x[:, None, :2] - locs[None]) ** 2).sum(-1) / (2.0 * scales[None] ** 2))
    Z = np.hstack((X, x[:, 2:])).astype(np.float32).astype(np.float64)
    d = X.shape[1]
    Sig0inv, mu0 = np.eye(d) / (sigsq + mn**2), mn * np.ones(d)

    def post(z, w):
        prec = Sig0inv + (z[:, :-1] * w[:, None]).T @ z[:, :-1] / sigsq
        Sig = np.linalg.inv(prec)
        return Sig @ (Sig0inv @ mu0 + z[:, :-1].T @ (w * z[:, -1]) / sigsq), Sig

    mup, Sigp = post(Z, np.ones(Z.shape[0]))
    w, p, _ = coreset.get()
    muw, Sigw = post(np.asarray(p, np.float64), np.asarray(w, np.float64))
    rkl = tgauss.kl_divergence_np(muw, Sigw, mup, np.linalg.inv(Sigp))
    np.testing.assert_allclose(_col(tt, "rklw")[-1], rkl, rtol=1e-4)


def test_linear_regression_lowrank_refit_keeps_the_mean():
    """ROADMAP Queue 3 (i): the realistic subsample of `linear_regression
    --data_num 300 --n_bases_per_scale 5` (17 rows, 31 bases; the driver's
    recipe for trial 1) takes the low-rank refit, whose f32 mean was 2.8%
    off the f64 QR refit's (the JAX package's, 3.2%).  It refits in f64:
    the mean and covariance agree with the f64 QR refit to 1e-8."""
    from bayesian_coresets_tpu_torch.models import linreg as tl
    rng = np.random.default_rng(1)
    x = tdatasets.gen_synthetic_housing(rng, 300)
    sigsq, mn = x[:, 2].var(), x[:, 2].mean()
    counts = [5] * 6 + [1]
    scales = np.repeat([0.2, 0.4, 0.8, 1.2, 1.6, 2.0, 100.0], counts)
    locs = np.vstack([x[rng.choice(np.arange(x.shape[0]), replace=False, size=c), :2]
                      for c in counts])
    X = np.exp(-((x[:, None, :2] - locs[None]) ** 2).sum(-1) / (2.0 * scales[None] ** 2))
    Z = np.hstack((X, x[:, 2:])).astype(np.float32)
    Zhat = torch.as_tensor(Z[rng.integers(0, Z.shape[0], 17)])
    d = X.shape[1]
    mu0 = torch.full((d,), mn, dtype=torch.float32)
    Sig0inv = torch.eye(d) / float(sigsq + mn**2)
    mu, F = tl.weighted_post_lowrank(tl.lowrank_basis(mu0, Sig0inv, sigsq), Zhat,
                                     torch.ones(17))
    ref = tl.weighted_post(mu0.double(), Sig0inv.double(), sigsq, Zhat.double(),
                           torch.ones(17, dtype=torch.float64))
    Sig, Sig_ref = (F.double() @ F.double().T).numpy(), (ref.USig @ ref.USig.T).numpy()
    assert Zhat.shape[0] < d and mu.dtype == torch.float32
    np.testing.assert_allclose(mu.double().numpy(), ref.mu.numpy(), rtol=1e-6)
    assert np.linalg.norm(Sig - Sig_ref) <= 1e-6 * np.linalg.norm(Sig_ref)


def test_simple_lr_evaluates_heavy_weight_coresets():
    """ROADMAP Queue 3 (k): at its defaults and seed 2 (on the CPU) GIGA puts
    ~2.4e10 of weight on one atom; the f32 Laplace refit of that coreset
    failed its Cholesky.  The evaluation fits in f64 give a finite KL."""
    from bayesian_coresets_tpu_torch.experiments import simple_lr
    kl, coreset = simple_lr.main(seed=2, verbose=False, device="cpu")
    wts, _, _ = coreset.get()
    assert wts.max() > 1e9 and coreset.size() <= 500
    assert np.isfinite(kl) and 0.0 <= kl < 10.0


G_FLAGS = {"data_num": 150, "data_dim": 40, "proj_dim": 60, "coreset_size_max": 30,
           "coreset_num_sizes": 4, "opt_itrs": 20, "trial": 1}


@pytest.fixture
def gaussian_x(monkeypatch):
    """The same data in both packages' Gaussian driver."""
    x = (1.0 + np.random.default_rng(5).normal(size=(G_FLAGS["data_num"],
                                                     G_FLAGS["data_dim"]))).astype(np.float32)
    monkeypatch.setattr(jgauss, "gen_synthetic", lambda key, n, d: jnp.asarray(x))
    monkeypatch.setattr(tgauss, "gen_synthetic", lambda gen, n, d: torch.as_tensor(x))
    return x


def test_gaussian_exact_matches_jax_and_pickle_is_numpy(gaussian_x, workdir):
    from bayesian_coresets_tpu.experiments import visualize as jvis
    jt, tt, _ = _both(JG.main, TG.main, {**G_FLAGS, "alg": "GIGA-OPT-EXACT"})
    np.testing.assert_array_equal(_col(jt, "csizes"), _col(tt, "csizes"))
    for k in ("rklw", "fklw", "mu_errs", "Sig_errs"):
        np.testing.assert_allclose(_col(tt, k), _col(jt, k), err_msg=k, **KL_TOL)
    import pickle
    with open("results_torch/coreset_data.pk", "rb") as f:
        dump = pickle.load(f)
    np.testing.assert_array_equal(dump[0], gaussian_x)
    leaves = list(dump[:6]) + list(dump[6]) + list(dump[7]) + list(dump[8:])
    assert all(type(a) is np.ndarray for a in leaves)
    pytest.importorskip("matplotlib")
    assert os.path.exists(jvis.plot_coreset_pts("results_torch/coreset_data.pk", "pts"))


def test_gaussian_giga_opt_rkl_within_jax_rule(gaussian_x, workdir):
    jt, tt, _ = _both(JG.main, TG.main, {**G_FLAGS, "alg": "GIGA-OPT"})
    rj, rt = _col(jt, "rklw"), _col(tt, "rklw")
    assert np.isfinite(rt).all() and rt[-1] < rt[0]
    assert rt[-1] <= 1.5 * rj[-1], (rt, rj)


@pytest.mark.parametrize("alg", ["SVI-EXACT", "SVI", "US", "BPSVI", "GIGA-REAL"])
def test_gaussian_sampled_algorithms_run(alg, workdir):
    TG.main(_argv({**G_FLAGS, "alg": alg, "device": "cpu"}))
    tt = tres.load_matching({"results_folder": "results/"})
    for k in ("rklw", "fklw", "mu_errs", "Sig_errs", "csizes"):
        assert np.isfinite(_col(tt, k)).all(), k
    assert (_col(tt, "csizes") <= _col(tt, "Ms")).all()
    if alg != "BPSVI":                 # BPSVI rebuilds at each size
        assert _col(tt, "rklw")[-1] < _col(tt, "rklw")[0]


# ----------------------------------------------------------------- logistic_poisson

def _tiny_lr(monkeypatch, n=120, d=3):
    """The JAX test's tiny logistic data, in both packages' loader."""
    rng = np.random.default_rng(0)
    X = np.hstack([rng.normal(size=(n, d - 1)), np.ones((n, 1))])
    Y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-X @ np.ones(d))), 1.0, -1.0)
    Z = (Y[:, None] * X).astype(np.float32)
    data = (X.astype(np.float32), Y, Z, None, d)
    monkeypatch.setattr(jdatasets, "load_logistic", lambda name: data)
    monkeypatch.setattr(tdatasets, "load_logistic", lambda name: data)
    return Z


LP_FLAGS = {"model": "lr", "dataset": "synth_lr", "alg": "GIGA-OPT", "trial": 1,
            "mcmc_samples_full": 32, "mcmc_samples_coreset": 32, "mcmc_chains": 2,
            "proj_dim": 32, "coreset_size_max": 16, "coreset_num_sizes": 2,
            "fs_samples": 16, "max_treedepth": 8, "ess_gate": 1}


def test_full_cache_path_matches_jax():
    base = argparse.Namespace(model="lr", dataset="synth_lr", mcmc_samples_full=1000,
                              mcmc_chains=8, target_accept=0.9, max_treedepth=15, trial=1)
    for ns in (base, argparse.Namespace(**{**vars(base), "dense_mass": True}),
               argparse.Namespace(**{**vars(base), "trial": 2, "dataset": "ds1"})):
        assert TLP.full_cache_path(ns) == JLP.full_cache_path(ns)
    assert TLP.RHAT_GATE == JLP.RHAT_GATE and TLP.ESS_GATE == JLP.ESS_GATE


def test_logistic_full_data_posterior_matches_jax(workdir, monkeypatch):
    """Full-data NUTS in both packages on the same data: the cached means
    agree within 0.25 posterior sd; every metric column is finite."""
    _tiny_lr(monkeypatch)
    flags = {**LP_FLAGS, "mcmc_samples_full": 512, "mcmc_chains": 4, "coreset_num_sizes": 1}
    for main, sub, extra in ((JLP.main, "jax", {}), (TLP.main, "torch", {"device": "cpu"})):
        os.makedirs(sub)
        os.chdir(sub)
        main(_argv({**flags, **extra}))
        os.chdir("..")
    path = TLP.full_cache_path(argparse.Namespace(**flags, target_accept=0.9))
    with np.load(os.path.join("jax", path)) as fj, np.load(os.path.join("torch", path)) as ft:
        sj, st = fj["samples"], ft["samples"]
        assert st.shape == sj.shape and float(ft["ess"]) > 50 and float(ft["rhat"]) < 1.1
    sd = sj.std(axis=0)
    assert (np.abs(st.mean(axis=0) - sj.mean(axis=0)) < 0.25 * sd).all(), \
        (st.mean(axis=0), sj.mean(axis=0), sd)
    tt = tres.load_matching({}, folder="torch/results/")
    jt = jres.load_matching({}, folder="jax/results/")
    assert set(tt.columns) - TIMING == set(jt.columns) - TIMING
    for k in set(tt.columns) - TIMING:
        if tt[k].dtype.kind == "f":
            assert np.isfinite(tt[k]).all(), k


def test_logistic_ess_gate_triggers_dense_retry(workdir, monkeypatch, capsys):
    _tiny_lr(monkeypatch)
    info = TLP.main(_argv({**LP_FLAGS, "ess_gate": 10_000, "coreset_num_sizes": 1,
                           "device": "cpu"}))
    out = capsys.readouterr().out
    assert "retrying with dense mass matrix" in out
    assert "not converged" in out and "min ESS" in out
    assert info["dense_retries"] == 1 and info["cpu_retries"] == 0
    assert set(info["seconds"]) == {"data", "full_nuts", "laplace", "build",
                                    "coreset_nuts", "metrics"}
    tt = tres.load_matching({"results_folder": "results/"})
    assert np.isfinite(tt["rklw"]).all()
    # rerun: memoized, returns None and adds no row
    assert TLP.main(_argv({**LP_FLAGS, "ess_gate": 10_000, "coreset_num_sizes": 1,
                           "device": "cpu"})) is None
    assert tres.read_csv("results/manifest.csv").nrows == 1


def test_logistic_cpu_fallback_retries_on_the_cpu(workdir, monkeypatch, capsys):
    """--cpu_fallback (off by default): chains that fail the gates after the
    dense retry run once more, dense, on the CPU."""
    _tiny_lr(monkeypatch)
    runs = []
    run = TLP.mcmc.run
    monkeypatch.setattr(TLP.mcmc, "run", lambda *a, **kw: runs.append(kw) or run(*a, **kw))
    info = TLP.main(_argv({**LP_FLAGS, "ess_gate": 10_000, "coreset_num_sizes": 1,
                           "device": "cpu"}, "--cpu_fallback"))
    out = capsys.readouterr().out
    assert "retrying with dense mass matrix" in out and "retrying on CPU" in out
    assert info["dense_retries"] == 1 and info["cpu_retries"] == 1
    # full data, the coreset, its dense retry, its CPU retry (dense)
    assert [kw["dense_mass"] for kw in runs] == [False, False, True, True]
    tt = tres.load_matching({"results_folder": "results/"})
    assert np.isfinite(tt["rklw"]).all() and np.isfinite(tt["esses"]).all()


def test_logistic_svi_warm_start(workdir, monkeypatch):
    _tiny_lr(monkeypatch)
    info = TLP.main(_argv({**LP_FLAGS, "alg": "SVI", "opt_itrs": 20,
                           "mcmc_samples_coreset": 64, "device": "cpu"}))
    tt = tres.load_matching({"results_folder": "results/"})
    assert np.isfinite(tt["rklw"]).all()
    assert tt["mu_errs"][-1] < 0.6
    assert info["coreset"].size() <= LP_FLAGS["coreset_size_max"]


def test_logistic_giga_opt_puts_more_than_n_on_an_atom_in_both_packages():
    """The data of chip_smoke.py's logistic_poisson run (its recipe and
    seed), cut from N=100k to 10k rows: GIGA-OPT's build from the same 500
    Laplace samples puts more than N of weight on one atom in the JAX
    package and in the port alike, with the same support and weights
    (rtol 1e-4) at every size of that run's grid.  So "the largest weight
    is at most N" is not a property of the reference algorithm here."""
    import bayesian_coresets_tpu as jbc
    import bayesian_coresets_tpu_torch as tbc
    from bayesian_coresets_tpu.models import logistic as jlog
    from bayesian_coresets_tpu_torch.models import logistic as tlog
    from bayesian_coresets_tpu_torch.models.laplace import laplace_approx

    N, D, S = 10_000, 10, 500
    rng = np.random.default_rng(18)
    X = np.hstack([rng.normal(size=(N, D - 1)), np.ones((N, 1))])
    y = np.where(rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-X @ np.ones(D))), 1.0, -1.0)
    Z = (y[:, None] * X).astype(np.float32)
    lap = laplace_approx(torch.as_tensor(Z), torch.ones(N), torch.zeros(D),
                         grad_fn=tlog.grad_th_log_joint, hess_fn=tlog.hess_th_log_joint)
    th = (lap.mu.double().numpy() + np.random.default_rng(3).normal(size=(S, D))
          @ lap.USig.double().numpy().T).astype(np.float32)
    tc = tbc.HilbertCoreset(torch.as_tensor(Z), tbc.BlackBoxProjector(
        lambda gen, n, w, p: torch.as_tensor(th[:n]), S, tlog.log_likelihood,
        generator=torch.Generator().manual_seed(0), device="cpu"), seed=1)
    jc = jbc.HilbertCoreset(Z, jbc.BlackBoxProjector(
        lambda key, n, w, p: jnp.asarray(th[:n]), S, jlog.log_likelihood), seed=1)
    done = 0
    for M in (1, 10, 100, 1000):
        tc.build(M - done)
        jc.build(M - done)
        done = M
        (tw, _, ti), (jw, _, ji) = tc.get(), jc.get()
        to, jo = np.argsort(np.asarray(ti)), np.argsort(np.asarray(ji))
        np.testing.assert_array_equal(np.asarray(ti)[to], np.asarray(ji)[jo])
        np.testing.assert_allclose(np.asarray(tw)[to], np.asarray(jw)[jo], rtol=1e-4)
    assert np.asarray(jw).max() > N and np.asarray(tw).max() > N, (jw.max(), tw.max())


@pytest.mark.parametrize("driver,flag", [(TLP, "--data_mesh=4"), (TLP, "--chain_mesh"),
                                         (TG, "--data_mesh=2"), (TLR, "--data_mesh=4")])
def test_sharding_flags_raise_before_any_work(driver, flag, workdir, monkeypatch):
    """Outside a process group (no torchrun) the sharding flags raise with
    the command that starts one, before any work; under a group they run
    (tests/test_torch_parallel.py)."""
    monkeypatch.setattr(tdatasets, "load_logistic", lambda name: pytest.fail("work began"))
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        driver.main(["run", flag, "--device", "cpu"])
    assert not os.path.exists("results")


# ----------------------------------------------------------------- imports, plots

def test_experiments_import_no_jax_jax_package_or_pandas():
    code = (
        "import importlib, sys\n"
        "import bayesian_coresets_tpu_torch\n"
        "assert 'bayesian_coresets_tpu_torch.experiments' not in sys.modules\n"
        "for m in ('cli', 'data_prep', 'datasets', 'gaussian', 'linear_regression',\n"
        "          'logistic_poisson', 'plotting', 'results', 'simple_lr',\n"
        "          'synthetic_vectors', 'visualize'):\n"
        "    importlib.import_module('bayesian_coresets_tpu_torch.experiments.' + m)\n"
        "importlib.import_module('bayesian_coresets_tpu_torch.utils.prng')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'bayesian_coresets_tpu', 'pandas', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)


def test_plot_subcommand_and_visualize(workdir):
    pytest.importorskip("matplotlib")
    from bayesian_coresets_tpu_torch.experiments import visualize
    for alg in ("GIGA", "FW"):
        TSV.main(["run", "--alg", alg, "--data_num", "32", "--data_type", "axis",
                  "--coreset_size_max", "16", "--coreset_num_sizes", "3", "--device", "cpu"])
    TSV.main(["plot", "Ms", "err", "--plot_legend", "alg", "--plot_out", "out.png",
              "--data_num", "32", "--data_type", "axis", "--coreset_size_max", "16",
              "--coreset_num_sizes", "3", "--summarize", "trial"])
    TSV.main(["plot", "Ms", "err", "--groupby", "Ms", "--plot_out", "band.png",
              "--data_num", "32", "--data_type", "axis", "--coreset_size_max", "16",
              "--coreset_num_sizes", "3", "--plot_y_type", "linear", "--summarize", "alg"])
    assert os.path.exists("out.png") and os.path.exists("band.png")
    visualize.main(["housing", "h.png"])
    assert os.path.exists("h.png")
