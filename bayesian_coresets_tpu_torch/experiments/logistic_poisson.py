"""Logistic / Poisson regression coreset experiment with weighted NUTS.

Port of ``bayesian_coresets_tpu/experiments/logistic_poisson.py``
(reference ``examples/logistic_poisson_regression/main.py``): datasets from
``BC_DATA_DIR``, cached full-data MCMC, Laplace-based projectors (tuned /
untuned / black-box, warm-started for SparseVI and BatchPSVI), five
algorithms (SVI, GIGA-OPT, GIGA-REAL, US, BPSVI), per-size weighted-NUTS
coreset posteriors, and metrics (reverse/forward KL vs the moment-matched
full posterior, relative mean/cov errors, gradient F-norm Fs, build and
MCMC timings), gated on split R-hat and ESS with a dense-metric retry.

Each random stage draws from a generator of its own
(:func:`..utils.prng.fold_seed` with the trial and a stage tag): 0 the
full-data chains, 1 the realistic subsample, 2 the projectors' samples,
(3, m) and (4, m) the coreset chains at grid point m and their dense retry,
(5, m) the opt-in CPU retry.

Run:  python -m bayesian_coresets_tpu_torch.experiments.logistic_poisson run \
          --model lr --dataset synth_lr --alg GIGA-OPT --trial 1
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import coresets as bc
from .. import mcmc
from ..models import logistic, poisson
from ..models.gaussian import kl_divergence_np
from ..models.laplace import laplace_approx, sample_laplace
from ..parallel import CHAIN_AXIS
from ..utils import config, prng, set_verbosity
from . import datasets, results
from .cli import (SELECT_DTYPES, chain_mesh, coreset_size_grid, data_mesh, dispatch,
                  make_parser, rank0, step_sched)

ALGS = ["SVI", "GIGA-OPT", "GIGA-REAL", "US", "BPSVI"]

# convergence gates on the samples feeding the quality metrics (Vehtari et
# al. 2021: gate BOTH mixing and sample size — an R-hat of 1.01 with a bulk
# ESS of 15 is still a worthless estimate).  Runs failing either gate are
# retried (see below) and warned about loudly.
RHAT_GATE = 1.1     # max split-R-hat over dims (1.01 production, 1.1 failure)
ESS_GATE = 100.0    # min bulk-ESS over dims (Vehtari et al. recommend >=100)


def unconverged(rhat: float, ess_v: float, ess_gate: float = ESS_GATE) -> bool:
    return rhat > RHAT_GATE or ess_v < ess_gate


def full_cache_path(arguments) -> str:
    """Full-data MCMC cache file for these arguments (the JAX package's
    path, so either package finds the other's cache).

    The reference keyed its cache only by (model, dataset)
    (examples/logistic_poisson_regression/main.py:107-127), so changing the
    sample count, chain setup, or trial silently reused stale samples.  The
    key here covers every input that changes the cached chains.
    """
    tag = (f"{arguments.model}_{arguments.dataset}"
           f"_n{arguments.mcmc_samples_full}_c{arguments.mcmc_chains}"
           f"_a{arguments.target_accept}_d{arguments.max_treedepth}"
           f"_t{arguments.trial}"
           + ("_dm" if getattr(arguments, "dense_mass", False) else ""))
    return os.path.join("mcmc_cache", f"full_samples_{tag}.npz")


def chain_diagnostics(res) -> tuple[float, float]:
    """(max split-R-hat over dims, min ESS over dims) for an MCMCResult."""
    rhat = float(torch.max(mcmc.split_rhat(res.samples)))
    ess_v = float(torch.min(mcmc.ess(res.samples)))
    return rhat, ess_v


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def laplace_refits(model, dth: int, dev):
    """The black-box projector's samplers, which refit a Laplace
    approximation to the current weighted coreset (reference
    main.py:156-163): ``(sampler, warm_sampler, init_carry)`` for
    ``BlackBoxProjector``.  An empty coreset gives the prior N(0, I) (an
    all-zero-weight coreset also yields the prior); the test is on the
    points' shape, so it holds inside a captured graph.

    The warm variant serves SparseVI's and BatchPSVI's Adam steps: each
    refits the Laplace approximation, but weights move little per step, so
    Newton from the carried previous mode needs ~3 damped iterations
    instead of 20 from zero (quadratic convergence tracking a
    slowly-moving optimum).  ``init_carry`` (run once per build entry)
    does the full-depth solve.  No refit reads the host (the Cholesky
    factors are NaN where they fail, as the JAX package's)."""
    zeros_th = torch.zeros(dth, device=dev)

    def prior_draws(gen, n):
        return torch.randn((n, dth), generator=gen, device=gen.device).to(dev)

    def sampler(gen, n, w, p):
        if p.numel() == 0:
            return prior_draws(gen, n)
        lap = laplace_approx(p, w, zeros_th, grad_fn=model.grad_th_log_joint,
                             hess_fn=model.hess_th_log_joint, num_iters=20)
        return sample_laplace(gen, lap, n)

    def init_carry(w, p):
        if p.numel() == 0:
            return zeros_th
        return laplace_approx(p, w, zeros_th, grad_fn=model.grad_th_log_joint,
                              hess_fn=model.hess_th_log_joint, num_iters=25).mu

    def warm_sampler(gen, n, w, p, mode):
        if p.numel() == 0:
            return prior_draws(gen, n), mode
        lap = laplace_approx(p, w, mode, grad_fn=model.grad_th_log_joint,
                             hess_fn=model.hess_th_log_joint, num_iters=3)
        return sample_laplace(gen, lap, n), lap.mu

    return sampler, warm_sampler, init_carry


def run(arguments):
    """Returns a dict: ``coreset`` (the coreset built), ``seconds`` (wall
    seconds by stage: ``data``, ``full_nuts``, ``laplace``, ``build``,
    ``coreset_nuts`` over every grid point and retry, ``metrics``),
    ``dense_retries`` (grid points retried with the dense metric) and
    ``cpu_retries`` (grid points retried on the CPU, ``--cpu_fallback``
    only); None when the results already exist."""
    dmesh = data_mesh(arguments, "logistic_poisson")
    cmesh = chain_mesh(arguments, "logistic_poisson")
    if results.check_exists(arguments):
        print(f"Results already exist for arguments {arguments}\nQuitting.")
        return None
    set_verbosity(arguments.verbosity)
    dev = config.default_device()
    secs = dict.fromkeys(("data", "full_nuts", "laplace", "build", "coreset_nuts",
                          "metrics"), 0.0)
    t0 = time.perf_counter()

    Ms = coreset_size_grid(arguments.coreset_size_max, arguments.coreset_num_sizes,
                           arguments.coreset_size_spacing, with_zero=False)

    if arguments.model == "lr":
        model = logistic
        X, Y, Z, Zt, D = datasets.load_logistic(arguments.dataset)
    else:
        model = poisson
        X, Y, Z, Zt, D = datasets.load_poisson(arguments.dataset)
    Z = torch.as_tensor(Z, device=dev)
    N, dz = Z.shape
    # theta dimension: lr folds y into z (theta dim = dz); poisson appends the
    # count column (theta dim = dz - 1)
    dth = dz if arguments.model == "lr" else dz - 1
    ones = torch.ones(N, device=dev)
    zeros_th = torch.zeros(dth, device=dev)
    _sync(dev)
    secs["data"] = time.perf_counter() - t0

    # full-data posterior via weighted NUTS, cached (reference main.py:107-127;
    # cache key fixed to cover sample count / chains / trial, see
    # full_cache_path).  Chains are batched with pooled adaptation.
    nc = max(1, int(arguments.mcmc_chains))
    if cmesh is not None:
        # chains round up to a multiple of the ranks (logistic_poisson.py:99-109 there)
        world = cmesh.axis_size(CHAIN_AXIS)
        nc = -(-nc // world) * world
        print(f"chain mesh: {world} ranks x {nc // world} chains/rank")
    n_full = -(-arguments.mcmc_samples_full // nc)   # kept draws per chain
    cache = full_cache_path(arguments)
    if os.path.exists(cache):
        print("Full MCMC cache exists, loading")
        with np.load(cache) as tmp:
            full_samples = tmp["samples"]
            full_mcmc_time_per_itr = float(tmp["t"])
            full_rhat = float(tmp["rhat"])
            full_ess = float(tmp["ess"])
    else:
        print(f"Running full-data MCMC ({nc} chains x {n_full} draws)")
        t0 = time.perf_counter()
        # warmup = the full single-chain burn length (reference iter=2N
        # convention): adaptation quality must not shrink with chain count
        full_samples, t_full, res_full = mcmc.run(
            model, Z, ones, n_full, prng.fold_seed(arguments.trial, 0, device=dev), d=dth,
            num_chains=nc, target_accept=arguments.target_accept,
            pooled_adaptation=nc > 1, num_warmup=arguments.mcmc_samples_full,
            max_depth=arguments.max_treedepth, dense_mass=arguments.dense_mass, mesh=cmesh)
        full_samples = full_samples.cpu().numpy()
        full_rhat, full_ess = chain_diagnostics(res_full)
        full_mcmc_time_per_itr = t_full / (nc * n_full * 2)
        if rank0():
            os.makedirs("mcmc_cache", exist_ok=True)
            np.savez(cache, samples=full_samples, t=full_mcmc_time_per_itr,
                     rhat=full_rhat, ess=full_ess)
        secs["full_nuts"] = time.perf_counter() - t0
    if unconverged(full_rhat, full_ess, arguments.ess_gate):
        print(f"WARNING: full-data chains not converged "
              f"(max split-R-hat {full_rhat:.3f} > {RHAT_GATE} or "
              f"min ESS {full_ess:.0f} < {arguments.ess_gate}); "
              f"metrics below compare against unconverged samples")

    mup = full_samples.mean(axis=0)
    Sigp = np.cov(full_samples, rowvar=False)
    SigpInv = np.linalg.inv(Sigp)

    # Laplace-based projectors (reference main.py:142-163)
    print("Fitting Laplace approximations")
    t0 = time.perf_counter()
    lap_opt = laplace_approx(Z, ones, zeros_th, grad_fn=model.grad_th_log_joint,
                             hess_fn=model.hess_th_log_joint)
    gsub = prng.fold_seed(arguments.trial, 1, device=dev)
    Zhat = Z[torch.randint(0, N, (int(np.sqrt(N)),), generator=gsub, device=dev)]
    lap_real = laplace_approx(Zhat, torch.ones(Zhat.shape[0], device=dev), zeros_th,
                              grad_fn=model.grad_th_log_joint,
                              hess_fn=model.hess_th_log_joint)
    _sync(dev)
    secs["laplace"] = time.perf_counter() - t0

    S = arguments.proj_dim
    sampler_opt = lambda gen, n, w, p: sample_laplace(gen, lap_opt, n)
    sampler_real = lambda gen, n, w, p: sample_laplace(gen, lap_real, n)

    sampler_bb, sampler_bb_warm, init_carry_bb = laplace_refits(model, dth, dev)

    def projector(sampler, warm=False):
        # the gradient with respect to the whole row, which BatchPSVI moves
        kw = (dict(grad_loglikelihood=model.grad_row_log_likelihood,
                   warm_sampler=sampler_bb_warm, init_carry=init_carry_bb) if warm else {})
        return bc.BlackBoxProjector(sampler, S, model.log_likelihood,
                                    generator=prng.fold_seed(arguments.trial, 2, device=dev),
                                    **kw)

    sched = step_sched(arguments.step_sched)
    seed = arguments.trial
    stream = getattr(arguments, "stream_chunk_size", 0) or None

    def make_alg(name):
        sd = SELECT_DTYPES[arguments.select_dtype]
        if name == "SVI":
            return bc.SparseVICoreset(Z, projector(sampler_bb, warm=True),
                                      opt_itrs=arguments.opt_itrs, step_sched=sched, seed=seed,
                                      capacity=int(arguments.coreset_size_max))
        if name == "GIGA-OPT":
            return bc.HilbertCoreset(Z, projector(sampler_opt), seed=seed,
                                     select_dtype=sd, stream_chunk_size=stream, mesh=dmesh)
        if name == "GIGA-REAL":
            return bc.HilbertCoreset(Z, projector(sampler_real), seed=seed,
                                     select_dtype=sd, stream_chunk_size=stream, mesh=dmesh)
        if name == "US":
            return bc.UniformSamplingCoreset(Z, seed=seed)
        if name == "BPSVI":
            return bc.BatchPSVICoreset(Z, projector(sampler_bb, warm=True),
                                       opt_itrs=arguments.opt_itrs, step_sched=sched, seed=seed)
        raise ValueError(name)

    t0 = time.perf_counter()
    alg = make_alg(arguments.alg)
    _sync(dev)
    secs["build"] = time.perf_counter() - t0

    nM = Ms.shape[0]
    cputs = np.zeros(nM)
    mcmc_time_per_itr = np.zeros(nM)
    csizes = np.zeros(nM)
    Fs = np.zeros(nM)
    rklw = np.zeros(nM)
    fklw = np.zeros(nM)
    mu_errs = np.zeros(nM)
    Sig_errs = np.zeros(nM)
    rhats = np.zeros(nM)
    esses = np.zeros(nM)
    dense_retries = cpu_retries = 0

    # precompute full-data gradient sums over posterior samples for Fs
    # (reference main.py:226-228, vectorized instead of a python loop)
    t0 = time.perf_counter()
    ths = torch.as_tensor(full_samples[: arguments.fs_samples], dtype=torch.float32, device=dev)
    gfs = model.grad_th_log_joint(Z, ths, ones).cpu().numpy()
    secs["metrics"] += time.perf_counter() - t0

    def nuts(pts_m, wts_m, n_cst, gen, dense):
        t0 = time.perf_counter()
        out = mcmc.run(model, pts_m, wts_m, n_cst, gen, d=dth, num_chains=nc,
                       target_accept=arguments.target_accept, pooled_adaptation=nc > 1,
                       num_warmup=arguments.mcmc_samples_coreset,
                       max_depth=arguments.max_treedepth, dense_mass=dense, mesh=cmesh)
        secs["coreset_nuts"] += time.perf_counter() - t0
        return out

    t_alg = 0.0
    for m in range(nM):
        print(f"M = {Ms[m]}: coreset construction, {arguments.alg} "
              f"{arguments.dataset} {arguments.trial}")
        t0 = time.perf_counter()
        if arguments.alg == "BPSVI":
            alg.build(int(Ms[m]))       # size semantics (reference bpsvi.py:15-22)
        else:
            itrs = int(Ms[m] if m == 0 else Ms[m] - Ms[m - 1])
            alg.build(itrs)
        t_alg += time.perf_counter() - t0
        wts, pts, idcs = alg.get()

        print(f"M = {Ms[m]}: weighted NUTS on coreset")
        if wts.shape[0] == 0:
            pts_m = np.zeros((1, dz), np.float32)
            wts_m = np.zeros(1, np.float32)
        else:
            pts_m, wts_m = np.asarray(pts, np.float32), np.asarray(wts, np.float32)
        # pad the coreset to a power-of-two bucket with zero weights: the
        # padded rows contribute exactly nothing to the log-density, and the
        # shapes NUTS sees come from a few buckets instead of every size
        pad = 1 << int(np.ceil(np.log2(max(pts_m.shape[0], 8))))
        pts_m = np.vstack([pts_m, np.zeros((pad - pts_m.shape[0], dz), np.float32)])
        wts_m = np.concatenate([wts_m, np.zeros(pad - wts_m.shape[0], np.float32)])
        pts_t = torch.as_tensor(pts_m, device=dev)
        wts_t = torch.as_tensor(wts_m, device=dev)
        n_cst = -(-arguments.mcmc_samples_coreset // nc)
        cst_samples, t_cst, res_cst = nuts(pts_t, wts_t, n_cst,
                                           prng.fold_seed(arguments.trial, 3, m, device=dev),
                                           arguments.dense_mass)
        rhats[m], esses[m] = chain_diagnostics(res_cst)
        if unconverged(rhats[m], esses[m], arguments.ess_gate) \
                and not arguments.dense_mass:
            # first retry stays ON the device with the dense (d, d) metric
            # (residual posterior correlation the diagonal cannot equalize)
            print(f"M = {Ms[m]}: coreset chains unconverged "
                  f"(split-R-hat {rhats[m]:.3f}, min ESS {esses[m]:.0f}); "
                  f"retrying with dense mass matrix")
            dense_retries += 1
            cst_samples, t_cst, res_cst = nuts(pts_t, wts_t, n_cst,
                                               prng.fold_seed(arguments.trial, 4, m, device=dev),
                                               True)
            rhats[m], esses[m] = chain_diagnostics(res_cst)
        if unconverged(rhats[m], esses[m], arguments.ess_gate) \
                and arguments.cpu_fallback:
            # last resort, opt-in only: the same dense-metric chains on the
            # host CPU, never on a card path unless asked for
            print(f"M = {Ms[m]}: coreset chains unconverged on the device "
                  f"(split-R-hat {rhats[m]:.3f}, min ESS {esses[m]:.0f}); "
                  f"retrying on CPU")
            cpu = torch.device("cpu")
            cpu_retries += 1
            t0 = time.perf_counter()
            cst_samples, t_cst, res_cst = mcmc.run(
                model, pts_t.to(cpu), wts_t.to(cpu), n_cst,
                prng.fold_seed(arguments.trial, 5, m, device=cpu), d=dth, num_chains=nc,
                target_accept=arguments.target_accept, pooled_adaptation=nc > 1,
                num_warmup=arguments.mcmc_samples_coreset,
                max_depth=arguments.max_treedepth, dense_mass=True)
            secs["coreset_nuts"] += time.perf_counter() - t0
            rhats[m], esses[m] = chain_diagnostics(res_cst)
        if unconverged(rhats[m], esses[m], arguments.ess_gate):
            print(f"WARNING: coreset chains at M={Ms[m]} not converged "
                  f"(max split-R-hat {rhats[m]:.3f} > {RHAT_GATE} or "
                  f"min ESS {esses[m]:.0f} < {arguments.ess_gate})")

        t0 = time.perf_counter()
        cst_samples = cst_samples.cpu().numpy()
        muw = cst_samples.mean(axis=0)
        Sigw = np.cov(cst_samples, rowvar=False)

        cputs[m] = t_alg
        mcmc_time_per_itr[m] = t_cst / (nc * n_cst * 2)
        csizes[m] = (wts_m > 0).sum()
        gcs = model.grad_th_log_joint(pts_t, ths, wts_t).cpu().numpy()
        Fs[m] = (((gcs - gfs) ** 2).sum(axis=1)).mean()
        # quality metrics in f64 on host: the small-KL tail (rKL < 1e-2,
        # exactly where parity is judged) underflows in f32 trace/logdet
        # cancellation (see models/gaussian.kl_divergence_np)
        rklw[m] = kl_divergence_np(muw, Sigw, mup, SigpInv)
        fklw[m] = kl_divergence_np(mup, Sigp, muw, np.linalg.inv(
            np.asarray(Sigw, np.float64)))
        mu_errs[m] = np.linalg.norm(mup - muw) / np.linalg.norm(mup)
        Sig_errs[m] = np.linalg.norm(Sigp - Sigw) / np.linalg.norm(Sigp)
        secs["metrics"] += time.perf_counter() - t0
        print(f"M = {Ms[m]}: rkl={rklw[m]:.4f} fkl={fklw[m]:.4f} Fs={Fs[m]:.3e} "
              f"rhat={rhats[m]:.3f} minESS={esses[m]:.0f}")
    secs["build"] += t_alg

    if rank0():
        results.save(arguments, csizes=csizes, Ms=Ms, cputs=cputs, Fs=Fs,
                     full_mcmc_time_per_itr=np.full(nM, full_mcmc_time_per_itr),
                     mcmc_time_per_itr=mcmc_time_per_itr, rklw=rklw, fklw=fklw,
                     mu_errs=mu_errs, Sig_errs=Sig_errs, rhats=rhats, esses=esses,
                     full_rhat=np.full(nM, full_rhat), full_ess=np.full(nM, full_ess))
    return {"coreset": alg, "seconds": secs, "dense_retries": dense_retries,
            "cpu_retries": cpu_retries}


def main(argv=None):
    parser, run_p, _ = make_parser(
        "Logistic/Poisson regression coreset experiment with weighted NUTS")
    run_p.set_defaults(func=run)
    parser.add_argument("--model", choices=["lr", "poiss"], default="lr")
    parser.add_argument("--dataset", type=str, default="synth_lr")
    parser.add_argument("--alg", type=str, default="GIGA-OPT", choices=ALGS)
    parser.add_argument("--mcmc_samples_full", type=int, default=10000)
    parser.add_argument("--mcmc_samples_coreset", type=int, default=10000)
    parser.add_argument("--mcmc_chains", type=int, default=8,
                        help="NUTS chains batched on the device (pooled adaptation "
                             "when >1)")
    parser.add_argument("--target_accept", type=float, default=0.9,
                        help="NUTS acceptance target (Stan adapt_delta)")
    parser.add_argument("--dense_mass", action="store_true",
                        help="adapt a full (d, d) covariance metric (Stan's "
                             "dense_e) — for correlated posteriors a diagonal "
                             "cannot equalize (e.g. airportdelays); without "
                             "this flag the driver still auto-retries "
                             "unconverged coreset chains with dense_e")
    parser.add_argument("--ess_gate", type=float, default=ESS_GATE,
                        help="min bulk-ESS (over dims, all chains pooled) a "
                             "run must reach before its metrics are recorded; "
                             "failing runs retry like an R-hat failure")
    parser.add_argument("--cpu_fallback", action="store_true",
                        help="retry still-unconverged coreset chains on the host "
                             "CPU (last resort, off by default)")
    parser.add_argument("--data_mesh", type=int, default=0,
                        help="(GIGA-*) shard dataset rows over this many ranks, one per "
                             "GPU: run under torchrun --nproc-per-node N -m "
                             "bayesian_coresets_tpu_torch.experiments.logistic_poisson "
                             "run ...")
    parser.add_argument("--chain_mesh", action="store_true",
                        help="shard NUTS chains over every rank of the process group "
                             "(under torchrun, as --data_mesh); chains round up to a "
                             "multiple of the rank count")
    parser.add_argument("--max_treedepth", type=int, default=15,
                        help="NUTS max tree depth (reference control "
                             "max_treedepth=15, mcmc.py:58)")
    parser.add_argument("--proj_dim", type=int, default=500)
    parser.add_argument("--fs_samples", type=int, default=1000,
                        help="posterior samples used for the Fs metric")
    parser.add_argument("--coreset_size_max", type=int, default=1000)
    parser.add_argument("--coreset_num_sizes", type=int, default=7)
    parser.add_argument("--coreset_size_spacing", choices=["log", "linear"], default="log")
    parser.add_argument("--opt_itrs", type=int, default=100)
    parser.add_argument("--step_sched", type=str, default="inv")
    parser.add_argument("--select_dtype", choices=["f32", "bf16", "int8"], default="f32",
                        help="reduced-precision selection copy for Hilbert solvers")
    parser.add_argument("--stream_chunk_size", type=int, default=0,
                        help="(GIGA-*) chunked projection with int8-resident "
                             "storage: beyond-HBM datasets on one device")
    return dispatch(parser, argv)


if __name__ == "__main__":
    main()
