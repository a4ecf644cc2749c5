"""Bayesian logistic regression with the z = y*x folding trick.

Port of ``bayesian_coresets_tpu/models/logistic.py`` (reference
``examples/common/model_lr.py:3-116``): stable log-likelihood and its
stable per-datum difference from a reference point, standard-normal prior,
closed-form gradients and the weighted log-joint Hessian as one
contraction.

Data convention: each row z_i = y_i * x_i with y in {-1, +1}, so
  log p(y_i | x_i, th) = -softplus(-z_i . th).
Prior: th ~ N(0, I).
"""

from __future__ import annotations

import torch

_LOG2PI = 1.8378770664093453


def _atleast_2d(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() >= 2 else x.reshape(1, -1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) in the form ``jax.nn.softplus`` evaluates
    (``logaddexp(x, 0)``): exact for every x, with no threshold cut like
    ``torch.nn.functional.softplus``'s ``threshold=20``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _logits(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    z = _atleast_2d(z)
    th = _atleast_2d(th)
    # accumulate at (at least) the input precision, never below f32
    acc = torch.promote_types(z.dtype, torch.float32)
    return z.to(acc) @ th.to(acc).T                        # (n, S)


def log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S) log-likelihood matrix (model_lr.py:25-32 semantics)."""
    return -_softplus(-_logits(z, th))


def _softplus_diff(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """softplus(p) - softplus(q) without large-magnitude cancellation
    (logistic.py:36-60 of the JAX package).

    log(1+e^p) - log(1+e^q) = log1p(sigmoid(q) expm1(p - q)) carries error
    relative to its own small magnitude.  The expm1 argument is kept
    non-negative (roles of p and q flipped for d < 0: for d <= -17, f32
    expm1(d) is -1 and log1p(-1) = -inf) and clipped to 30, past which the
    direct difference takes over: both branches, and so their gradients
    through ``where``, stay finite everywhere.
    """
    d = p - q
    da = torch.clamp(d.abs(), 0.0, 30.0)
    pos = torch.log1p(torch.sigmoid(q) * torch.expm1(da))
    neg = -torch.log1p(torch.sigmoid(p) * torch.expm1(da))
    stable = torch.where(d >= 0, pos, neg)
    direct = _softplus(p) - _softplus(q)
    return torch.where(d.abs() < 30.0, stable, direct)


def log_likelihood_diff(z: torch.Tensor, th: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(n, S) of ll(z, th) - ll(z, ref), computed stably (logistic.py:63-75):
    the weighted MCMC's mode-relative density sums these per-datum
    differences, each accurate relative to its own magnitude."""
    a = _logits(z, th)                                     # (n, S)
    b = _logits(z, _atleast_2d(ref))[:, :1]                # (n, 1)
    # ll = -softplus(-v): diff = softplus(-b) - softplus(-a)
    return _softplus_diff(-b, -a)


def log_prior(th: torch.Tensor) -> torch.Tensor:
    th = _atleast_2d(th)
    return -0.5 * th.shape[1] * _LOG2PI - 0.5 * torch.sum(th**2, dim=1)


def log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S,) weighted log-joint: sum_i w_i ll_i(th) + log prior (model_lr.py:39-40)."""
    return torch.sum(wts[:, None] * log_likelihood(z, th), dim=0) + log_prior(th)


def grad_th_log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S, d): d/dth -softplus(-z.th) = sigmoid(-z.th) * z (model_lr.py:42-49)."""
    s = torch.sigmoid(-_logits(z, th))                     # (n, S)
    return s[:, :, None] * _atleast_2d(z)[:, None, :]


def grad_z_log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S, d): gradient with respect to the (folded) datapoint z
    (model_lr.py:51-58)."""
    s = torch.sigmoid(-_logits(z, th))
    return s[:, :, None] * _atleast_2d(th)[None, :, :]


# the whole row is the (folded) datapoint, which BatchPSVI moves
grad_row_log_likelihood = grad_z_log_likelihood


def grad_th_log_prior(th: torch.Tensor) -> torch.Tensor:
    return -_atleast_2d(th)


def grad_th_log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S, d) gradient of the weighted log-joint (model_lr.py:63-64)."""
    return grad_th_log_prior(th) + torch.einsum(
        "n,nsd->sd", wts, grad_th_log_likelihood(z, th))


def _sig_pp(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """sigmoid'(logit) = sig*(1-sig), batched (n, S)."""
    s = torch.sigmoid(_logits(z, th))
    return s * (1.0 - s)


def hess_th_log_likelihood(z: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """(n, S, d, d) per-datum Hessians (model_lr.py:66-73)."""
    z = _atleast_2d(z)
    m = _sig_pp(z, th)
    return -m[:, :, None, None] * z[:, None, :, None] * z[:, None, None, :]


def hess_th_log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S, d, d) Hessian of the weighted log-joint (model_lr.py:79-80),
    computed as -I - (w*m Z)^T Z without the (n, S, d, d) tensor."""
    z = _atleast_2d(z)
    m = _sig_pp(z, th) * wts[:, None]                      # (n, S)
    hess_ll = -torch.einsum("ns,ni,nj->sij", m, z, z)
    eye = torch.eye(z.shape[1], dtype=z.dtype, device=z.device)
    return hess_ll - eye[None, :, :]


def diag_hess_th_log_joint(z: torch.Tensor, th: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(S, d) diagonal of the weighted log-joint's Hessian (model_lr.py:82-92)."""
    z = _atleast_2d(z)
    m = _sig_pp(z, th) * wts[:, None]
    return -torch.einsum("ns,ni->si", m, z**2) - 1.0


def gen_synthetic(gen: torch.Generator, n: int, d: int = 2,
                  theta_scale: float = 3.0, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Synthetic LR data (model_lr.py:15-23): returns folded Z = y*x.

    Draws on the generator's device, then moves the result to ``device``
    (default: the generator's device)."""
    gdev = gen.device
    th = theta_scale * torch.ones(d, dtype=dtype, device=gdev)
    x = torch.randn((n, d), generator=gen, dtype=dtype, device=gdev)
    ps = torch.sigmoid(x @ th)
    u = torch.rand((n,), generator=gen, dtype=dtype, device=gdev)
    y = torch.where(u <= ps, 1.0, -1.0).to(dtype)
    return (y[:, None] * x).to(device if device is not None else gdev)
