"""BatchPSVI's fit at coreset sizes 1 and 10 through ``logistic_poisson``,
in the JAX package and in the PyTorch port, on the CPU, on the same data
and with the same flags.

The data follow ``chip_smoke.py``'s phase 18 recipe (``_logistic_data``,
``_poisson_data``: D=10, N(0, 1) covariates and the intercept last, the
same seeds), cut to ``--n`` rows; the flags are phase 18's BatchPSVI run
(proj_dim 500, opt_itrs 100, 8 chains, 400 draws by default).  With
``--model poiss`` the JAX driver gets the whole row's gradient (the
Poisson ``grad_z_log_likelihood`` with a zero column for the count): its
own covers the covariates alone, and its BatchPSVI raises without it.

    python scripts/bpsvi_sizes_cpu.py --model lr --n 20000 --trials 1,2,3

Prints one JSON object: rKL at each size, per trial, for each package.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D, SEEDS = 10, {"lr": 18, "poiss": 19}


def write_data(model, n, folder):
    """``chip_smoke.py``'s data for ``model``, ``n`` training rows."""
    rng = np.random.default_rng(SEEDS[model])

    def covariates(m):
        return np.hstack([rng.normal(size=(m, D - 1)), np.ones((m, 1))])

    if model == "lr":
        X = covariates(n)
        y = np.where(rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ np.ones(D))), 1.0, -1.0)
        np.savez(os.path.join(folder, "synth_lr.npz"), X=X, y=y)
        return "synth_lr"
    theta = np.append(np.full(D - 1, (D - 1) ** -0.5), 0.0)
    X = covariates(n)
    y = rng.poisson(np.logaddexp(0.0, X @ theta)).astype(np.float64)
    Xt = covariates(n // 10)
    yt = rng.poisson(np.logaddexp(0.0, Xt @ theta)).astype(np.float64)
    np.savez(os.path.join(folder, "synth_poiss.npz"), X=X, y=y, Xt=Xt, yt=yt)
    return "synth_poiss"


def argv(model, dataset, trial, draws, device=None):
    flags = {"model": model, "dataset": dataset, "alg": "BPSVI", "proj_dim": 500,
             "coreset_size_max": 10, "coreset_num_sizes": 2, "coreset_size_spacing": "log",
             "max_treedepth": 15, "target_accept": 0.9, "mcmc_chains": 8, "trial": trial,
             "mcmc_samples_full": draws, "mcmc_samples_coreset": draws, "opt_itrs": 100}
    if device:
        flags["device"] = device
    return ["run"] + [x for k, v in flags.items() for x in (f"--{k}", str(v))]


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=sorted(SEEDS), default="lr")
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--trials", default="1")
    p.add_argument("--draws", type=int, default=400)
    a = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bayesian_coresets_tpu.experiments import datasets as jdatasets
    from bayesian_coresets_tpu.experiments import logistic_poisson as JLP
    from bayesian_coresets_tpu.experiments import results as jres
    from bayesian_coresets_tpu.models import poisson as jpoisson
    from bayesian_coresets_tpu_torch.experiments import logistic_poisson as TLP
    from bayesian_coresets_tpu_torch.experiments import results as tres

    if a.model == "poiss":
        grad = jpoisson.grad_z_log_likelihood
        jpoisson.grad_z_log_likelihood = lambda z, th: (
            lambda g: jnp.concatenate([g, jnp.zeros_like(g[:, :, :1])], axis=2))(grad(z, th))
    out = {"model": a.model, "n": a.n, "draws": a.draws, "sizes": [1, 10],
           "rklw": {"jax": [], "torch": []}, "seconds": {"jax": 0.0, "torch": 0.0}}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        dataset = write_data(a.model, a.n, data)
        os.environ["BC_DATA_DIR"] = data
        jdatasets.DATA_DIRS.insert(0, data)
        for pkg, run, res, device in (("jax", JLP.main, jres, None),
                                      ("torch", TLP.main, tres, "cpu")):
            for trial in (int(t) for t in a.trials.split(",")):
                work = os.path.join(tmp, f"{pkg}{trial}")
                os.makedirs(work)
                os.chdir(work)
                t0 = time.perf_counter()
                run(argv(a.model, dataset, trial, a.draws, device))
                out["seconds"][pkg] += time.perf_counter() - t0
                table = res.load_matching({}, folder="results/")
                out["rklw"][pkg].append([float(x) for x in table["rklw"]])
                os.chdir(tmp)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
