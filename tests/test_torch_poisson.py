"""The port's Poisson regression model against the JAX package's, on numpy
inputs made from a seed: every public function within rtol 1e-5, atol 1e-6
in f32 (the (n, S) logits are one matmul on each side, summed in another
order), with logits below the -25 guard among the cases.  The model must
also serve unmodified as ``model`` of ``mcmc.weighted.run`` and
``fit_laplace``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_coresets_tpu.mcmc import weighted as jweighted
from bayesian_coresets_tpu.models import poisson as jp
from bayesian_coresets_tpu_torch import mcmc
from bayesian_coresets_tpu_torch.mcmc import weighted
from bayesian_coresets_tpu_torch.models import poisson as tp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N, D, S = 40, 3, 7


def _inputs(case, seed=0):
    """(z, th, wts): rows [x, y] with counts; ``floor`` puts some logits
    below -25 (and some far above 0) through large covariates.  x and th are
    multiples of 1/8, so the logits are exact in f32 whatever the order of
    the sum: a logit of 50 rounded in another place would move the stable
    differences by more than the tolerance."""
    rng = np.random.default_rng(seed)
    x = (np.round(8 * rng.normal(size=(N, D))) / 8).astype(np.float32)
    th = (np.round(8 * rng.normal(size=(S, D))) / 8).astype(np.float32)
    if case == "floor":
        x[::4] *= 24.0
    y = rng.poisson(np.log1p(np.exp(np.clip(x @ np.ones(D), -5, 5)))).astype(np.float32)
    if case == "floor":
        assert ((x @ th.T) < -25.0).any() and ((x @ th.T) > 25.0).any()
    z = np.concatenate([x, y[:, None]], axis=1)
    return z, th, rng.uniform(0.0, 2.0, size=N).astype(np.float32)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


CASES = ["moderate", "floor"]
FUNCS = ["compute_s", "log_likelihood", "log_likelihood_diff", "log_prior", "log_joint",
         "grad_th_log_likelihood", "grad_z_log_likelihood", "grad_th_log_prior",
         "grad_th_log_joint", "hess_th_log_joint", "diag_hess_th_log_joint"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", FUNCS)
def test_function_matches_jax(fn, case):
    z, th, w = _inputs(case)
    if fn == "compute_s":
        args = (th, z[:, :-1])
    elif fn == "log_likelihood_diff":
        args = (z, th, th[3] * 0.5)
    elif fn in ("log_prior", "grad_th_log_prior"):
        args = (th,)
    elif fn in ("log_joint", "grad_th_log_joint", "hess_th_log_joint", "diag_hess_th_log_joint"):
        args = (z, th, w)
    else:
        args = (z, th)
    want = np.asarray(getattr(jp, fn)(*map(jnp.asarray, args)))
    got = getattr(tp, fn)(*_t(*args)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    # sums over n of terms up to ~1e3 each: the tolerance is relative to them
    scale = max(1.0, float(np.abs(want).max())) if "joint" in fn else 1.0
    keep = np.ones(want.shape, bool)
    if fn == "log_likelihood_diff":
        # where lam(a) << lam(b), log1p(dlam / lam_b) takes the log of a
        # rounded 1 + ratio in both packages: those entries carry the last
        # bits of sigmoid and expm1, and are held to rtol 2e-2 instead
        va, vb = z[:, :-1] @ th.T, (z[:, :-1] @ args[2])[:, None]
        lam = lambda v: np.logaddexp(v.astype(np.float64), 0.0)   # noqa: E731
        keep = (lam(va) / lam(vb) > 1e-2) | (va <= -25.0) | (vb <= -25.0)
        assert (~keep).sum() < 0.1 * keep.size
        np.testing.assert_allclose(got[~keep], want[~keep], rtol=2e-2)
    np.testing.assert_allclose(got[keep], want[keep], rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def test_single_theta_and_single_row_broadcast_like_jax():
    z, th, _ = _inputs("moderate", 1)
    np.testing.assert_allclose(tp.log_likelihood(*_t(z[0], th[0])).numpy(),
                               np.asarray(jp.log_likelihood(jnp.asarray(z[0]), jnp.asarray(th[0]))),
                               **TOL)
    assert tp.log_likelihood(*_t(z[0], th[0])).shape == (1, 1)


def test_diff_is_stabler_than_subtraction_in_f32():
    """The stable difference in f32 is closer to the f64 difference than
    subtracting two f32 log-likelihoods (what is left is the rounding of
    the two logits)."""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=(200, 1)), np.ones((200, 1))], axis=1) * 3.0
    th = np.array([[1.0, 2.0]])
    ref = th[0] + 1e-3
    y = rng.poisson(np.log1p(np.exp(x @ th[0]))).astype(np.float64)
    z = np.concatenate([x, y[:, None]], axis=1)
    z64, th64, ref64 = (torch.as_tensor(a, dtype=torch.float64) for a in (z, th, ref))
    exact = (tp.log_likelihood(z64, th64) - tp.log_likelihood(z64, ref64[None])).numpy()
    z32, th32, ref32 = (t.float() for t in (z64, th64, ref64))
    stable = tp.log_likelihood_diff(z32, th32, ref32).double().numpy()
    naive = (tp.log_likelihood(z32, th32) - tp.log_likelihood(z32, ref32[None])).double().numpy()
    assert np.abs(stable - exact).max() < 0.5 * np.abs(naive - exact).max()


def test_gen_synthetic_matches_jax_in_distribution():
    n = 20000
    zt = tp.gen_synthetic(torch.Generator().manual_seed(0), n).numpy()
    zj = np.asarray(jp.gen_synthetic(jax.random.key(0), n))
    assert zt.shape == zj.shape == (n, 3) and zt.dtype == np.float32
    assert (zt[:, 1] == 1.0).all() and (zt[:, 2] >= 0).all()
    assert (zt[:, 2] == np.round(zt[:, 2])).all()
    for col in (0, 2):      # standard errors of the means: 1/sqrt(n), ~1.3/sqrt(n)
        assert abs(zt[:, col].mean() - zj[:, col].mean()) < 6 * 1.3 / np.sqrt(n)
    assert abs(zt[:, 2].var() - zj[:, 2].var()) < 0.15
    # the count follows its rate: E[y | x1] = softplus(x1)
    hi = zt[:, 0] > 1.0
    assert abs(zt[hi, 2].mean() - np.log1p(np.exp(zt[hi, 0])).mean()) < 0.1


def test_serves_weighted_mcmc_and_laplace():
    """``fit_laplace`` finds the JAX package's mode; a short weighted NUTS
    run has the posterior's mean."""
    z, _, w = _inputs("moderate", 3)
    zt, wt = _t(z, w)
    lap = weighted.fit_laplace(tp, zt, wt, D)
    jl = jweighted.fit_laplace(jp, jnp.asarray(z), jnp.asarray(w), D)
    np.testing.assert_allclose(lap.mu.numpy(), np.asarray(jl.mu), rtol=1e-3, atol=1e-4)
    _, _, res = weighted.run(tp, zt, wt, 100, torch.Generator().manual_seed(1), d=D,
                             num_chains=8, num_warmup=100)
    s = res.samples
    assert s.shape == (8, 100, D) and bool(torch.isfinite(s).all())
    sd = s.reshape(-1, D).std(dim=0)
    assert float(((s.reshape(-1, D).mean(dim=0) - lap.mu).abs() / sd).max()) < 0.5
    assert float(mcmc.split_rhat(s).max()) < 1.2
