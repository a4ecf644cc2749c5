"""Raw sparse-NNLS solver comparison on synthetic vectors.

Port of ``bayesian_coresets_tpu/experiments/synthetic_vectors.py``
(reference ``examples/synthetic_vectors/main.py``): FW / GIGA / OMP / US
run directly on random-normal or axis-aligned vectors through a trivial
identity projector; the metric is the solver residual ``error()``.  The
data comes from ``np.random.default_rng(trial)``, so both packages solve
the same problem; GIGA, FW and OMP select through the GIGA select kernel
on the card.

Run:  python -m bayesian_coresets_tpu_torch.experiments.synthetic_vectors run --alg GIGA --trial 1
Plot: python -m bayesian_coresets_tpu_torch.experiments.synthetic_vectors plot Ms err --plot_legend alg
"""

from __future__ import annotations

import time

import numpy as np

from .. import coresets as bc
from ..ops import GIGA, FrankWolfe, OrthoPursuit, UniformSampling
from ..utils import set_verbosity
from . import results
from .cli import coreset_size_grid, dispatch, make_parser

ALGS = {"FW": FrankWolfe, "GIGA": GIGA, "OMP": OrthoPursuit, "US": UniformSampling}


def run(arguments):
    """Returns the coreset built (None when the results already exist)."""
    if results.check_exists(arguments):
        print(f"Results already exist for arguments {arguments}\nQuitting.")
        return None
    set_verbosity(arguments.verbosity)
    rng = np.random.default_rng(arguments.trial)

    Ms = coreset_size_grid(arguments.coreset_size_max, arguments.coreset_num_sizes,
                           arguments.coreset_size_spacing, with_zero=False)

    if arguments.data_type == "normal":
        X = rng.normal(size=(arguments.data_num, arguments.data_dim)).astype(np.float32)
    else:
        X = np.eye(arguments.data_num, dtype=np.float32)

    alg = bc.HilbertCoreset(X, bc.FamilyProjector(bc.identity_tangent_family()),
                            snnls=ALGS[arguments.alg], seed=arguments.trial,
                            max_active=int(arguments.coreset_size_max) + 8)

    err = np.zeros(Ms.shape[0])
    csize = np.zeros(Ms.shape[0])
    cput = np.zeros(Ms.shape[0])
    print(f"data: {arguments.data_type}, trial {arguments.trial}, alg: {arguments.alg}")
    t_total = 0.0
    for m, M in enumerate(Ms):
        t0 = time.perf_counter()
        itrs = int(Ms[m] if m == 0 else Ms[m] - Ms[m - 1])
        alg.build(itrs)
        t_total += time.perf_counter() - t0
        cput[m] = t_total
        wts, pts, idcs = alg.get()
        csize[m] = (wts > 0).sum()
        err[m] = alg.error()

    results.save(arguments, err=err, csize=csize, Ms=Ms, cput=cput)
    return alg


def main(argv=None):
    parser, run_p, _ = make_parser("Sparse nonnegative regression comparison (PyTorch/CUDA)")
    run_p.set_defaults(func=run)
    parser.add_argument("--alg", type=str, default="GIGA", choices=list(ALGS))
    parser.add_argument("--data_num", type=int, default=10000)
    parser.add_argument("--data_dim", type=int, default=100)
    parser.add_argument("--data_type", choices=["normal", "axis"], default="normal")
    parser.add_argument("--coreset_size_max", type=int, default=1000)
    parser.add_argument("--coreset_num_sizes", type=int, default=50)
    parser.add_argument("--coreset_size_spacing", choices=["log", "linear"], default="log")
    return dispatch(parser, argv)


if __name__ == "__main__":
    main()
