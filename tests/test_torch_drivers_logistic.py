"""``logistic_poisson``'s logistic GIGA-REAL and US arms against the JAX
package on the CPU, on ``_tiny_lr``'s data in both packages' loader, run
and held as ``tests/test_torch_drivers_poisson.py`` runs and holds the
Poisson arms (``trial_runs``, ``hold_trials``).  US draws its atoms with
numpy from the trial in both packages: the same sizes too."""

import pytest
import torch

from test_torch_drivers_poisson import RUN_FLAGS, hold_trials, trial_runs
from test_torch_experiments import LP_FLAGS, _tiny_lr

torch.set_num_threads(1)

# with RUN_FLAGS' draws, the port's final rKL on trials 1-6 of a CPU was
# 0.18-5.0 of JAX's for GIGA-REAL (median over TRIALS 0.32) and 0.84-1.13
# for US (median 1.00)


@pytest.fixture(scope="module")
def logistic_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("logistic")
    with pytest.MonkeyPatch.context() as mp:
        _tiny_lr(mp)
        mp.chdir(tmp)
        return trial_runs({**LP_FLAGS, **RUN_FLAGS}, ("GIGA-REAL", "US"))


@pytest.mark.parametrize("alg", ["GIGA-REAL", "US"])
def test_logistic_real_and_uniform_match_jax(alg, logistic_runs):
    """Logistic GIGA-REAL and US in both packages on the same tiny data:
    ``hold_trials``."""
    hold_trials(logistic_runs[alg], same_sizes=alg == "US")
