"""Bayesian Poisson regression with softplus rate link.

Port of ``bayesian_coresets_tpu/models/poisson.py`` (reference
``examples/common/model_poiss.py:4-113``): rate lambda = softplus(x . th),
counts y ~ Poisson(lambda), th ~ N(0, I).  The reference's log-log
stability guard ``compute_s`` (model_poiss.py:25-30) is a branch-free
``torch.where`` over the softplus; all (n, S) matrices come from one
x @ th.T product.

Data convention: each row z_i = [x_i, y_i] (covariates, then the count).
"""

from __future__ import annotations

import torch

from .logistic import _atleast_2d, _softplus, _softplus_diff

_LOG2PI = 1.8378770664093453
# Below this logit, log(softplus(v)) ~= v to ~1e-11 and f32 softplus underflows.
_V_FLOOR = -25.0


def _split(z: torch.Tensor):
    z = _atleast_2d(z)
    return z[:, :-1], z[:, -1]


def _logits(x: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    th = _atleast_2d(th)
    # accumulate at (at least) the input precision, never below f32
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc) @ th.to(acc).T                        # (n, S)


def compute_s(th: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Stable log(softplus(x.th)); the reference's guard at model_poiss.py:25-30."""
    v = _logits(x, th)
    return torch.where(v > _V_FLOOR, torch.log(torch.clamp_min(_softplus(v), 1e-38)), v)


def log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S) Poisson log-likelihood (model_poiss.py:32-38)."""
    x, y = _split(z)
    lam = _softplus(_logits(x, th))
    return y[:, None] * compute_s(th, x) - torch.lgamma(y + 1.0)[:, None] - lam


def log_likelihood_diff(z: torch.Tensor, th: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(n, S) of ll(z, th) - ll(z, ref), computed stably (poisson.py:52-80 of
    the JAX package).

    The mode-relative weighted density sums per-datum DIFFERENCES; plain
    subtraction cancels for count data (|ll_i| ~ y log y reaches 1e3-1e4).
    Exact identities keep every term accurate relative to its own size:

      lam(a) - lam(b)         = log1p(sigmoid(b) expm1(a-b))
      log lam(a) - log lam(b) = log1p((lam(a) - lam(b)) / lam(b))

    and lgamma(y+1) cancels exactly.  Outside the softplus guard region
    (v <= -25, where s ~= v and rates are ~1e-11) it subtracts directly.
    """
    x, y = _split(z)
    ref = _atleast_2d(ref)
    va = _logits(x, th)                                    # (n, S)
    vb = _logits(x, ref)[:, :1]                            # (n, 1)
    dlam = _softplus_diff(va, vb)
    lam_b = torch.clamp_min(_softplus(vb), 1e-38)
    ds_stable = torch.log1p(torch.clamp_min(dlam / lam_b, -1.0 + 1e-7))
    ds_direct = compute_s(th, x) - compute_s(ref, x)[:, :1]
    ds = torch.where((va > _V_FLOOR) & (vb > _V_FLOOR), ds_stable, ds_direct)
    return y[:, None] * ds - dlam


def log_prior(th: torch.Tensor) -> torch.Tensor:
    th = _atleast_2d(th)
    return -0.5 * th.shape[1] * _LOG2PI - 0.5 * torch.sum(th**2, dim=1)


def log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S,) weighted log-joint: sum_i w_i ll_i(th) + log prior."""
    return torch.sum(wts[:, None] * log_likelihood(z, th), dim=0) + log_prior(th)


def _rate_score(z: torch.Tensor, th: torch.Tensor):
    """g = d/dv [y log lam - lam] = (y/lam - 1) * sigmoid(v), stabilized:
    sigmoid(v)/softplus(v) -> 1 as v -> -inf, so g -> y - lam smoothly (the
    reference guards the same cancellation at model_poiss.py:47-55)."""
    x, y = _split(z)
    v = _logits(x, th)
    sig = torch.sigmoid(v)
    safe_lam = torch.clamp_min(_softplus(v), 1e-30)
    ratio = torch.where(v > _V_FLOOR, sig / safe_lam, 1.0)
    return y[:, None] * ratio - sig, x


def grad_th_log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S, d) gradient with respect to theta (model_poiss.py:47-55)."""
    g, x = _rate_score(z, th)
    return g[:, :, None] * x[:, None, :]


def grad_z_log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S, d) gradient with respect to the covariates x (the count is
    left out; model_poiss.py:57-65)."""
    g, _ = _rate_score(z, th)
    return g[:, :, None] * _atleast_2d(th)[None, :, :]


def grad_row_log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S, d+1) gradient with respect to the whole row z = [x, y]: the
    covariates' (``grad_z_log_likelihood``), then 0 for the count, which a
    pseudo-point keeps.  BatchPSVI moves rows of z, and
    ``grad_z_log_likelihood``'s d columns do not cover them (ROADMAP Queue
    3 (m))."""
    g = grad_z_log_likelihood(z, th)
    return torch.cat([g, torch.zeros_like(g[:, :, :1])], dim=2)


def grad_th_log_prior(th: torch.Tensor) -> torch.Tensor:
    return -_atleast_2d(th)


def grad_th_log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S, d) gradient of the weighted log-joint."""
    return grad_th_log_prior(th) + torch.einsum(
        "n,nsd->sd", wts, grad_th_log_likelihood(z, th))


def _rate_curvature(z: torch.Tensor, th: torch.Tensor):
    """h = d^2/dv^2 [y log lam - lam], stabilized (model_poiss.py:67-75):
    h = y (sig(1-sig) lam - sig^2)/lam^2 - sig(1-sig); both terms vanish as
    v -> -inf, so the floor branch returns 0 there."""
    x, y = _split(z)
    v = _logits(x, th)
    sig = torch.sigmoid(v)
    safe_lam = torch.clamp_min(_softplus(v), 1e-30)
    curv = (sig * (1.0 - sig) * safe_lam - sig**2) / safe_lam**2
    return y[:, None] * torch.where(v > _V_FLOOR, curv, 0.0) - sig * (1.0 - sig), x


def hess_th_log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S, d, d) Hessian of the weighted log-joint as one contraction."""
    h, x = _rate_curvature(z, th)
    hess_ll = torch.einsum("ns,ni,nj->sij", h * wts[:, None], x, x)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    return hess_ll - eye[None, :, :]


def diag_hess_th_log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S, d) diagonal of the weighted log-joint's Hessian."""
    h, x = _rate_curvature(z, th)
    return torch.einsum("ns,ni->si", h * wts[:, None], x**2) - 1.0


def gen_synthetic(gen: torch.Generator, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Synthetic Poisson data (model_poiss.py:19-23): rows [x1, 1, y] with
    x1 ~ N(0, 1) and y ~ Poisson(softplus(x1)).

    Draws on the generator's device, then moves the result to ``device``
    (default: the generator's device)."""
    gdev = gen.device
    x1 = torch.randn((n,), generator=gen, dtype=dtype, device=gdev)
    y = torch.poisson(_softplus(x1), generator=gen)
    z = torch.stack([x1, torch.ones(n, dtype=dtype, device=gdev), y], dim=1)
    return z.to(device if device is not None else gdev)
