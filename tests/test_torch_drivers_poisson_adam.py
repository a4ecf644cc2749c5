"""``logistic_poisson --model poiss``'s SparseVI and BatchPSVI arms (the
Poisson Laplace refits inside their Adam steps) against the JAX package
on the CPU, run and held as ``tests/test_torch_drivers_poisson.py`` runs
and holds the Poisson Hilbert and uniform arms; JAX's BatchPSVI gets the
whole row's gradient (ROADMAP Queue 3 (m))."""

import pytest
import torch

from test_torch_drivers_poisson import hold_poisson, poisson_trial_runs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def poisson_adam_runs(tmp_path_factory):
    return poisson_trial_runs(tmp_path_factory, ("SVI", "BPSVI"))


@pytest.mark.parametrize("alg", ["SVI", "BPSVI"])
def test_poisson_algorithms_run(alg, poisson_adam_runs):
    """``hold_poisson`` on the port's ``--model poiss`` SparseVI and
    BatchPSVI arms."""
    hold_poisson(poisson_adam_runs[alg], alg)
