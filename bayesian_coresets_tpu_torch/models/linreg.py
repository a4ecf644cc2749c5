"""Bayesian linear regression (conjugate, RBF-basis capable).

Port of ``bayesian_coresets_tpu/models/linreg.py`` (reference
``examples/common/model_linreg.py:4-37``): Gaussian likelihood with known
noise variance sigsq, Gaussian prior, the closed-form weighted posterior,
and the data-gradient used by pseudocoreset optimization.  Rows
z_i = [x_i, y_i] (features, then the response).

Model: y_i ~ N(x_i . th, sigsq), th ~ N(th0, Sig0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gaussian import WeightedPost, _atleast_2d, _randn, cholesky, kl_divergence  # noqa: F401

_LOG2PI = 1.8378770664093453

__all__ = [
    "log_likelihood",
    "grad_x_log_likelihood",
    "weighted_post",
    "sample_weighted_post",
    "weighted_post_lowrank",
    "lowrank_basis",
    "LowRankBasis",
    "kl_divergence",
    "rbf_features",
]


def _split(z: torch.Tensor):
    z = _atleast_2d(z)
    return z[:, :-1], z[:, -1]


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a number or a tensor) as a 0-dim tensor of ``like``'s dtype on
    its device, so that the CPU and the card divide alike.  A number is
    filled in on the device (a copy of it from the host would synchronize,
    and cannot run inside a captured CUDA graph)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def log_likelihood(z: torch.Tensor, th: torch.Tensor, sigsq) -> torch.Tensor:
    """(n, S) Gaussian regression log-likelihood (model_linreg.py:4-11).

    The residual is (y - x.th)^2, not the reference's expanded
    y^2 - 2 pred y + pred^2: equal in exact arithmetic, but the expanded form
    cancels in f32 when the posterior is concentrated (the centered
    projections underflow to zero).
    """
    x, y = _split(z)
    sigsq = _scalar(sigsq, x)
    resid_sq = (y[:, None] - x @ _atleast_2d(th).T) ** 2                 # (n, S)
    return -0.5 * (_LOG2PI + torch.log(sigsq)) - resid_sq / (2.0 * sigsq)


def grad_x_log_likelihood(z: torch.Tensor, th: torch.Tensor, sigsq) -> torch.Tensor:
    """(n, S, d+1) gradient with respect to the full row z = [x, y]:
    d/dx_j = (y - x.th) th_j / sigsq, d/dy = -(y - x.th) / sigsq.  (The
    reference, model_linreg.py:13-17, has +1 at the d/dy entry, a sign slip;
    like the JAX package this is the correct derivative.)"""
    x, y = _split(z)
    th = _atleast_2d(th)
    r = (y[:, None] - x @ th.T) / _scalar(sigsq, x)                      # (n, S)
    return torch.cat([r[:, :, None] * th[None, :, :], -r[:, :, None]], dim=2)


def weighted_post(th0, Sig0inv, sigsq, z, w) -> WeightedPost:
    """Closed-form weighted posterior (model_linreg.py:26-37): precision
    Sig0inv + X^T diag(w) X / sigsq, mean solving
    Prec mu = Sig0inv th0 + X^T (w y) / sigsq.

    By QR of the stacked weighted design [sqrt(w) X / sigma; L0^T], not by a
    Cholesky of the normal equations: the RBF designs of the
    linear_regression experiment have condition numbers far beyond f32's
    reach once squared.  R is sign-normalized to a positive diagonal (the
    unique upper-triangular factor), so it does not depend on the QR
    routine's conventions.
    """
    x, y = _split(z)
    d = th0.shape[0]
    sw = torch.sqrt(torch.clamp_min(w, 0.0))
    L0 = cholesky(Sig0inv)                               # Sig0inv = L0 L0^T
    srt = torch.sqrt(_scalar(sigsq, x))
    B = torch.cat([sw[:, None] * x / srt, L0.T], dim=0)
    c = torch.cat([sw * y / srt, L0.T @ th0], dim=0)
    Q, R = torch.linalg.qr(B, mode="reduced")            # prec = R^T R
    diag = torch.diagonal(R)
    s = torch.sign(torch.where(diag == 0, 1.0, diag))
    R = s[:, None] * R
    eye = torch.eye(d, dtype=R.dtype, device=R.device)
    USig = torch.linalg.solve_triangular(R, eye, upper=True)            # Sig = USig USig^T
    # least-squares mean: mu = R^{-1} Q^T c (never forms B^T B or B^T c)
    mu = torch.linalg.solve_triangular(R, (s * (Q.T @ c))[:, None], upper=True)[:, 0]
    return WeightedPost(mu, USig, R.T)


def sample_weighted_post(gen: torch.Generator, th0, Sig0inv, sigsq, z, w,
                         n_samples: int) -> torch.Tensor:
    """Samples mu + R^{-1} eps (covariance R^{-1} R^{-T} = Prec^{-1})."""
    post = weighted_post(th0, Sig0inv, sigsq, z, w)
    eps = _randn(gen, (n_samples, th0.shape[0]), post.USig)
    return post.mu + torch.linalg.solve_triangular(post.LSigInv.T, eps.T, upper=True).T


class LowRankBasis(NamedTuple):
    """One-time prior factorization for :func:`weighted_post_lowrank`, in f64."""

    L0inv: torch.Tensor    # (d, d) with Sig0inv = L0 L0^T
    L0invT: torch.Tensor   # (d, d)
    r0: torch.Tensor       # (d,) = Sig0inv @ th0
    sigsq: torch.Tensor    # noise variance (0-dim)


def lowrank_basis(th0, Sig0inv, sigsq) -> LowRankBasis:
    th0, Sig0inv = th0.double(), Sig0inv.double()
    d = th0.shape[0]
    L0 = cholesky(Sig0inv)
    eye = torch.eye(d, dtype=L0.dtype, device=L0.device)
    L0inv = torch.linalg.solve_triangular(L0, eye, upper=False)
    return LowRankBasis(L0inv, L0inv.T.contiguous(), Sig0inv @ th0, _scalar(sigsq, L0))


# Scaled Denman-Beavers steps of :func:`_sqrt_spd`: with the Frobenius-norm
# scaling below, they bring every eigenvalue of an (m, m) matrix with
# eigenvalues in [1, 1 + 1e16] and m <= 512 to its square root within f64
# rounding (tests/test_torch_linreg.py); a step past convergence leaves the
# iterates as they are
SQRT_STEPS = 10


def _sqrt_spd(A: torch.Tensor):
    """``(S, L)``: the symmetric square root S of the symmetric positive
    definite ``A`` (m, m), and A's lower Cholesky factor L, reading nothing
    on the host (a fixed step count; ``cholesky_ex`` does not check its
    error code).  Where a factorization fails, both are NaN, as
    ``gaussian.cholesky`` returns a failed factor.

    Product-form Denman-Beavers steps (Higham, Functions of Matrices,
    (6.29)): ``M_0 = Y_0 = A``, ``Y <- (g^{1/2} / 2) Y (I + M^{-1} / g)``,
    ``M <- I / 2 + (g M + M^{-1} / g) / 4``, so that Y -> A^{1/2} while
    M -> I.  The scale g = (|M^{-1}|_F / |M|_F)^{1/2} is the geometric mean
    of M's extreme eigenvalues' reciprocals up to a factor m^{1/4}: it
    takes the condition number c to about (c m^{1/2})^{1/2} / 4 at each
    step (the determinant's scaling, Higham's choice, barely moves the
    large eigenvalues when many are 1, as empty slots make them).  M^{-1}
    comes from its Cholesky factor, which reads only M's lower triangle;
    Y is made symmetric once, at the end."""
    m = A.shape[-1]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    half_eye = 0.5 * eye
    M, Y, LA, fails = A, A, None, None
    for _ in range(SQRT_STEPS):
        L, info = torch.linalg.cholesky_ex(M)
        LA, fails = (L, info) if LA is None else (LA, fails | info)
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        Minv = Li.T @ Li
        g2 = torch.linalg.vector_norm(Minv) / torch.linalg.vector_norm(M)   # g^2
        Minv_g = Minv * torch.rsqrt(g2)                                     # M^{-1} / g
        Y = torch.addmm(Y, Y, Minv_g) * (0.5 * g2 ** 0.25)
        M = torch.add(half_eye, torch.sqrt(g2) * M + Minv_g, alpha=0.25)
    ok = fails == 0
    above = torch.ones((m, m), dtype=torch.bool, device=A.device).tril(-1).mT
    return (torch.where(ok, 0.5 * (Y + Y.T), torch.nan),
            torch.where(ok | above, LA, torch.nan))


def weighted_post_lowrank(basis: LowRankBasis, z, w, residual: bool = False):
    """Weighted posterior by a RANK-m Woodbury update of the prior.

    The coreset design has only m = len(w) rows, so
    ``prec = Sig0inv + X^T diag(w) X / sigsq = L0 (I + W^T W) L0^T`` with
    ``W = diag(sqrt(w)) X L0^{-T} / sigma`` (m, d), and everything is done
    on the (m, m) ``A = I + W W^T`` in place of the (m+d, d) QR on
    SparseVI's per-Adam-step path (reference sparsevi.py:70-74).  With
    ``S = A^{1/2}`` (:func:`_sqrt_spd`, no eigenvectors):

    - mean: ``(I + W^T W)^{-1} (t0 + W^T b) = t0 + W^T A^{-1} (b - W t0)``
      with ``t0 = L0^{-1} Sig0inv th0`` and ``b = sqrt(w) y / sigma``, so the
      data term is never subtracted from itself;
    - factor: ``F = L0^{-T} (I + W^T W)^{-1/2} = L0^{-T} (I - W^T (A + S)^{-1} W)``,
      as ``(I + lam)^{-1/2} = 1 - lam / (1 + lam + (1 + lam)^{1/2})`` on each
      eigenvalue lam of W^T W.  A + S >= 2 I, and an empty slot (w = 0, a
      zero row of W) is a unit row of A: no eigenvalue needs a mask.

    Returns ``(mu, F)`` in ``z``'s dtype, F the symmetric form (``Sig = F
    F^T``), as the JAX package's eigh of the Gram returns them; with
    ``residual`` also ``|S^2 - A|_F / |A|_F`` (a 0-dim f64 device tensor,
    for checks made after the fact).  Only Cholesky factors, triangular
    solves and matmuls: nothing reads the host, so the refit runs inside a
    captured CUDA graph.  The Gram squares W's conditioning, so it is
    computed in f64 (in f32 the mean of a 17-row RBF design, precision
    condition 4.3e4, came out 2.8% off; the JAX package's f32 version:
    3.2%).  Weights are taken as nonnegative (negative ones count as 0).
    """
    x, y = _split(z.double())
    w = w.double()
    L0inv, L0invT, r0, sigsq = (t.double() for t in basis)
    sw = torch.sqrt(torch.clamp_min(w, 0.0))
    sig = torch.sqrt(sigsq)
    W = (sw[:, None] * x) @ L0invT / sig                                 # (m, d)
    A = W @ W.T
    A = 0.5 * (A + A.T) + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    S, L = _sqrt_spd(A)

    t0 = L0inv @ r0
    u = torch.linalg.solve_triangular(L, (sw * y / sig - W @ t0)[:, None], upper=False)
    u = torch.linalg.solve_triangular(L.T, u, upper=True)[:, 0]         # A^{-1} (b - W t0)
    mu = L0invT @ (t0 + W.T @ u)
    P = torch.linalg.solve_triangular(cholesky(A + S), W, upper=False)  # P^T P = W^T (A+S)^{-1} W
    F = L0invT - (L0invT @ P.T) @ P
    if residual:
        return mu.to(z.dtype), F.to(z.dtype), torch.linalg.norm(S @ S - A) / torch.linalg.norm(A)
    return mu.to(z.dtype), F.to(z.dtype)


def rbf_features(x: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Multi-scale RBF basis expansion of the linear_regression experiment
    (reference examples/linear_regression/main.py:80-108): features
    exp(-||x - c||^2 / (2 s^2)) for every (center, scale) pair.

    x: (n, p) raw inputs; centers: (k, p); scales: (m,).  Returns (n, k*m).
    """
    sq = torch.sum((x[:, None, :] - centers[None, :, :]) ** 2, dim=-1)   # (n, k)
    feats = torch.exp(-sq[:, :, None] / (2.0 * scales[None, None, :] ** 2))
    return feats.reshape(x.shape[0], -1)
