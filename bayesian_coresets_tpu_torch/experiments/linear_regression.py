"""Bayesian RBF linear-regression coreset experiment.

Port of ``bayesian_coresets_tpu/experiments/linear_regression.py``
(reference ``examples/linear_regression/main.py``): housing-price data (or
a synthetic stand-in — the reference's prices2018.npy is not distributed),
multi-scale RBF bases with a constant basis, closed-form posterior, seven
algorithms including the exact LinReg projector (second-order term
projected onto the top eigenvectors of X^T X), and the same closed-form
quality metrics.  The data, the bases, ``bV`` and the realistic subsample
come from ``np.random.default_rng(trial)``, so both packages get the same
inputs; the projectors' samples come from generator stage 1 of the trial.

Run:  python -m bayesian_coresets_tpu_torch.experiments.linear_regression run --alg GIGA-OPT --trial 1
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import coresets as bc
from ..models import linreg
from ..models.gaussian import kl_divergence_np
from ..utils import config, prng, set_verbosity
from . import datasets, results
from .cli import (SELECT_DTYPES, coreset_size_grid, data_mesh, dispatch, make_parser, rank0,
                  step_sched, to_numpy)

ALGS = ["SVI", "SVI-EXACT", "GIGA-OPT", "GIGA-OPT-EXACT", "GIGA-REAL",
        "GIGA-REAL-EXACT", "US"]


def _load_xy(arguments, rng):
    for d in datasets.data_dirs():
        path = os.path.join(d, "prices2018.npy")
        if os.path.exists(path):
            x = np.load(path)
            idcs = rng.permutation(x.shape[0])[: arguments.data_num]
            x = x[idcs]
            x[:, 2] = np.log10(x[:, 2])
            return x
    return datasets.gen_synthetic_housing(rng, arguments.data_num)


def run(arguments):
    """Returns the coreset built (None when the results already exist)."""
    mesh = data_mesh(arguments, "linear_regression")
    if results.check_exists(arguments):
        print(f"Results already exist for arguments {arguments}\nQuitting.")
        return None
    set_verbosity(arguments.verbosity)
    dev = config.default_device()
    rng = np.random.default_rng(arguments.trial)

    Ms = coreset_size_grid(arguments.coreset_size_max, arguments.coreset_num_sizes,
                           arguments.coreset_size_spacing)

    # data + multi-scale RBF bases (reference linear_regression/main.py:60-108)
    x = _load_xy(arguments, rng)
    datastd = x[:, 2].std()
    datamn = x[:, 2].mean()
    sigsq = datastd**2

    basis_unique_scales = np.array([0.2, 0.4, 0.8, 1.2, 1.6, 2.0, 100.0])
    basis_unique_counts = np.hstack(
        (arguments.n_bases_per_scale * np.ones(6, dtype=np.int64), 1))
    d = int(basis_unique_counts.sum())
    print(f"Basis dimension: {d}")

    mu0 = datamn * np.ones(d)
    Sig0 = (datastd**2 + datamn**2) * np.eye(d)
    Sig0inv = np.linalg.inv(Sig0)

    basis_scales = np.array([])
    basis_locs = np.zeros((0, 2))
    for i in range(basis_unique_scales.shape[0]):
        basis_scales = np.hstack(
            (basis_scales, basis_unique_scales[i] * np.ones(basis_unique_counts[i])))
        idcs = rng.choice(np.arange(x.shape[0]), replace=False,
                          size=basis_unique_counts[i])
        basis_locs = np.vstack((basis_locs, x[idcs, :2]))

    X = np.exp(-((x[:, None, :2] - basis_locs[None, :, :]) ** 2).sum(-1)
               / (2.0 * basis_scales[None, :] ** 2))
    Y = x[:, 2]
    Z = np.hstack((X, Y[:, None])).astype(np.float32)
    N = Z.shape[0]

    _, bV = np.linalg.eigh(X.T @ X)
    bV = bV[:, -arguments.proj_dim:]

    mu0_t = torch.as_tensor(mu0, dtype=torch.float32, device=dev)
    Sig0inv_t = torch.as_tensor(Sig0inv, dtype=torch.float32, device=dev)
    Zt = torch.as_tensor(Z, device=dev)
    ones = torch.ones(N, device=dev)

    # the quality metrics refit in f64: these RBF designs are conditioned far
    # beyond f32, where the refit's rounding swamps a small KL (and makes it
    # negative: ROADMAP Queue 3 (j))
    mu0_64, Sig0inv_64 = mu0_t.double(), Sig0inv_t.double()
    post = linreg.weighted_post(mu0_64, Sig0inv_64, sigsq, Zt.double(), ones.double())
    mup = to_numpy(post.mu)
    Sigp = to_numpy(post.USig @ post.USig.T)
    SigpInv = to_numpy(post.LSigInv @ post.LSigInv.T)

    loglik = lambda pts, th: linreg.log_likelihood(pts, th, sigsq)
    gradll = lambda pts, th: linreg.grad_x_log_likelihood(pts, th, sigsq)
    S = arguments.proj_dim

    def sampler_optimal(gen, n, w, p):
        return linreg.sample_weighted_post(gen, mu0_t, Sig0inv_t, sigsq, Zt, ones, n)

    sub = rng.integers(0, N, int(np.sqrt(N)))
    Zhat = Zt[torch.as_tensor(sub, device=dev)]

    def sampler_realistic(gen, n, w, p):
        return linreg.sample_weighted_post(gen, mu0_t, Sig0inv_t, sigsq, Zhat,
                                           torch.ones(Zhat.shape[0], device=dev), n)

    def sampler_bb(gen, n, w, p):
        if p.numel() == 0:
            w = torch.zeros(1, device=dev)
            p = torch.zeros((1, d + 1), device=dev)
        return linreg.sample_weighted_post(gen, mu0_t, Sig0inv_t, sigsq, p, w, n)

    def projector(sampler, grad=None):
        return bc.BlackBoxProjector(sampler, S, loglik, grad,
                                    generator=prng.fold_seed(arguments.trial, 1, device=dev))

    exact_family = bc.linreg_tangent_family(mu0_t, Sig0inv_t, sigsq,
                                            torch.as_tensor(bV, dtype=torch.float32, device=dev))
    sched = step_sched(arguments.step_sched)
    seed = arguments.trial
    stream = getattr(arguments, "stream_chunk_size", None) or None

    def make_alg(name):
        cap = int(arguments.coreset_size_max)   # slots for the whole sweep
        sd = SELECT_DTYPES[arguments.select_dtype]
        if name == "SVI":
            return bc.SparseVICoreset(Zt, projector(sampler_bb, gradll),
                                      opt_itrs=arguments.opt_itrs, step_sched=sched,
                                      seed=seed, capacity=cap)
        if name == "SVI-EXACT":
            return bc.SparseVICoreset(Zt, exact_family, opt_itrs=arguments.opt_itrs,
                                      step_sched=sched, seed=seed, capacity=cap)
        if name == "GIGA-OPT":
            return bc.HilbertCoreset(Zt, projector(sampler_optimal), seed=seed,
                                     select_dtype=sd, stream_chunk_size=stream, mesh=mesh)
        if name == "GIGA-OPT-EXACT":
            prj = bc.FamilyProjector(exact_family)
            prj.update(ones, Zt)
            return bc.HilbertCoreset(Zt, prj, seed=seed)
        if name == "GIGA-REAL":
            return bc.HilbertCoreset(Zt, projector(sampler_realistic), seed=seed,
                                     select_dtype=sd, stream_chunk_size=stream, mesh=mesh)
        if name == "GIGA-REAL-EXACT":
            prj = bc.FamilyProjector(exact_family)
            prj.update(torch.ones(Zhat.shape[0], device=dev), Zhat)
            return bc.HilbertCoreset(Zt, prj, seed=seed)
        if name == "US":
            return bc.UniformSamplingCoreset(Zt, seed=seed)
        raise ValueError(name)

    alg = make_alg(arguments.alg)

    nM = Ms.shape[0]
    w, p = [], []
    cputs = np.zeros(nM)
    t_build = 0.0
    for m in range(nM):
        print(f"M = {Ms[m]}: coreset construction, {arguments.alg} {arguments.trial}")
        t0 = time.perf_counter()
        itrs = int(Ms[m] if m == 0 else Ms[m] - Ms[m - 1])
        alg.build(itrs)
        t_build += time.perf_counter() - t0
        wts, pts, idcs = alg.get()
        w.append(wts)
        p.append(pts)
        cputs[m] = t_build

    csizes = np.zeros(nM)
    rklw = np.zeros(nM)
    fklw = np.zeros(nM)
    mu_errs = np.zeros(nM)
    Sig_errs = np.zeros(nM)
    for m in range(nM):
        csizes[m] = (w[m] > 0).sum()
        pts_m = np.atleast_2d(np.asarray(p[m], np.float64))
        if pts_m.shape[1] == 0:
            pts_m = np.zeros((1, d + 1))
        wts_m = np.asarray(w[m], np.float64)
        if wts_m.shape[0] == 0:
            wts_m = np.zeros(1)
        wp = linreg.weighted_post(mu0_64, Sig0inv_64, sigsq, torch.as_tensor(pts_m, device=dev),
                                  torch.as_tensor(wts_m, device=dev))
        Sigw = to_numpy(wp.USig @ wp.USig.T)
        muw = to_numpy(wp.mu)
        # f64 KL: the trace/logdet terms cancel far below f32 resolution on
        # these ill-conditioned designs (gaussian.kl_divergence_np)
        rklw[m] = kl_divergence_np(muw, Sigw, mup, SigpInv)
        fklw[m] = kl_divergence_np(mup, Sigp, muw, to_numpy(wp.LSigInv @ wp.LSigInv.T))
        mu_errs[m] = np.linalg.norm(mup - muw) / np.linalg.norm(mup)
        Sig_errs[m] = np.linalg.norm(Sigp - Sigw) / np.linalg.norm(Sigp)

    if rank0():
        results.save(arguments, csizes=csizes, Ms=Ms, cputs=cputs, rklw=rklw,
                     fklw=fklw, mu_errs=mu_errs, Sig_errs=Sig_errs)
    return alg


def main(argv=None):
    parser, run_p, _ = make_parser("RBF linear regression coreset experiment (PyTorch/CUDA)")
    run_p.set_defaults(func=run)
    parser.add_argument("--data_num", type=int, default=10000)
    parser.add_argument("--alg", type=str, default="GIGA-OPT", choices=ALGS)
    parser.add_argument("--proj_dim", type=int, default=100)
    parser.add_argument("--n_bases_per_scale", type=int, default=50)
    parser.add_argument("--coreset_size_max", type=int, default=300)
    parser.add_argument("--coreset_num_sizes", type=int, default=6)
    parser.add_argument("--coreset_size_spacing", choices=["log", "linear"], default="log")
    parser.add_argument("--opt_itrs", type=int, default=100)
    parser.add_argument("--step_sched", type=str, default="inv")
    parser.add_argument("--select_dtype", choices=["f32", "bf16", "int8"], default="f32",
                        help="reduced-precision selection copy for Hilbert solvers")
    parser.add_argument("--stream_chunk_size", type=int, default=0,
                        help="(GIGA-*) chunked projection with int8-resident "
                             "storage: beyond-HBM datasets on one device")
    parser.add_argument("--data_mesh", type=int, default=0,
                        help="(GIGA-*) shard dataset rows over this many ranks, one per "
                             "GPU: run under torchrun --nproc-per-node N -m "
                             "bayesian_coresets_tpu_torch.experiments.linear_regression "
                             "run ...")
    return dispatch(parser, argv)


if __name__ == "__main__":
    main()
