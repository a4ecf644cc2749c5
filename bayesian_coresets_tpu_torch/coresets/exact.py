"""Exact (closed-form) tangent families.

Port of ``bayesian_coresets_tpu/coresets/exact.py`` (the reference defines
these inline in its example scripts: ``GaussianProjector``,
examples/gaussian/main.py:117-135, ``LinRegProjector``,
examples/linear_regression/main.py:158-186, and ``IDProjector``,
examples/synthetic_vectors/main.py:82-89).  The projection context is the
closed-form weighted posterior, refit at every build or optimize step; no
Monte Carlo samples are drawn, so the generator is never read.
"""

from __future__ import annotations

import math

import torch

from ..models import gaussian, linreg
from .projector import TangentFamily


def gaussian_tangent_family(mu0, Sig0inv, Siginv, LSigInv,
                            basis: gaussian.PosteriorBasis | None = None) -> TangentFamily:
    """Exact tangent family for the conjugate Gaussian model.

    ``LSigInv`` is the lower Cholesky factor of the likelihood precision.
    Features have dimension d+1: ``[nu @ PsiL, sqrt(tr(Psi^T Psi)/2)]``
    scaled by sqrt(d+1), whose inner products equal the exact Hilbert inner
    products under the current coreset posterior.  The refit uses the
    one-time joint diagonalization (``basis``, computed here when not
    given), so each context costs O(d^2) matmuls.  Features depend on the
    basis only up to a rotation; their Gram does not.
    """
    d = mu0.shape[0]
    if basis is None:
        basis = gaussian.posterior_basis(mu0, Sig0inv, Siginv)
    scale = torch.tensor(math.sqrt(d + 1), dtype=LSigInv.dtype, device=LSigInv.device)

    def make_ctx(gen, wts, pts):
        return gaussian.weighted_post_basis(basis, pts, wts)

    def project(ctx, pts):
        muw, USigw = ctx
        nu = (gaussian._atleast_2d(pts) - muw) @ LSigInv            # (n, d)
        PsiL = LSigInv.T @ USigw                                    # (d, d)
        Psi = PsiL @ PsiL.T
        const = torch.sqrt(0.5 * torch.sum(Psi * Psi))
        feats = torch.cat([nu @ PsiL, const.expand(nu.shape[0], 1)], dim=1)
        return feats * scale

    def project_grad(ctx, pts):
        # d feats[:, s] / d x = (LSigInv @ PsiL)[:, s], constant in x; the
        # constant feature has zero gradient
        _, USigw = ctx
        G = LSigInv @ (LSigInv.T @ USigw)                           # (d, d)
        n = gaussian._atleast_2d(pts).shape[0]
        g = torch.cat([G.T, torch.zeros((1, d), dtype=G.dtype, device=G.device)], dim=0)
        return (g * scale)[None, :, :].expand(n, d + 1, d)

    return TangentFamily(make_ctx, project, project_grad)


def linreg_tangent_family(mu0, Sig0inv, sigsq, bV,
                          lowrank_refit: bool | None = None) -> TangentFamily:
    """Exact tangent family for Bayesian linear regression.

    ``bV`` (d, p): top-p eigenvectors of X^T X; the quadratic feature block
    is projected onto them, giving feature dimension d + p^2 (reference
    linear_regression/main.py:158-186).

    ``lowrank_refit``: use the rank-m Woodbury refit
    (:func:`models.linreg.weighted_post_lowrank`, a square root of the (m, m)
    Gram by Cholesky factors and matmuls) instead of the (m+d, d) QR on
    SparseVI's per-Adam-step path.  The default (None) takes it when the
    coreset's slot count m is at most the parameter dimension d, as the JAX
    package does; pass False for extremely ill-conditioned designs.  Neither
    refit reads the host, so SparseVI's Adam steps on this family replay as
    CUDA graphs as on every other family.
    """
    d = mu0.shape[0]
    lr_basis = linreg.lowrank_basis(mu0, Sig0inv, sigsq)
    sigsq_t = lr_basis.sigsq
    root2 = torch.sqrt(torch.full_like(sigsq_t, 2.0))

    def make_ctx(gen, wts, pts):
        if pts.numel() == 0:        # empty coreset: the prior
            wts = torch.zeros(1, dtype=mu0.dtype, device=mu0.device)
            pts = torch.zeros((1, d + 1), dtype=mu0.dtype, device=mu0.device)
        use_lr = (pts.shape[0] <= d) if lowrank_refit is None else lowrank_refit
        if use_lr:
            return linreg.weighted_post_lowrank(lr_basis, pts, wts)
        post = linreg.weighted_post(mu0, Sig0inv, sigsq_t, pts, wts)
        return post.mu, post.USig

    def project(ctx, pts):
        muw, USigw = ctx
        z = gaussian._atleast_2d(pts)
        X, Y = z[:, :-1], z[:, -1]
        beta = X @ USigw                                            # (n, d)
        nu = Y - X @ muw                                            # (n,)
        bproj = beta @ bV                                           # (n, p)
        quad = (bproj[:, :, None] * bproj[:, None, :]).reshape(z.shape[0], -1)
        return torch.cat([nu[:, None] * beta, quad / root2], dim=1) / sigsq_t

    return TangentFamily(make_ctx, project, None)


def identity_tangent_family() -> TangentFamily:
    """Raw-vector projector (reference synthetic_vectors IDProjector)."""
    return TangentFamily(
        make_ctx=lambda gen, wts, pts: None,
        project=lambda ctx, pts: gaussian._atleast_2d(pts),
        project_grad=None,
    )
