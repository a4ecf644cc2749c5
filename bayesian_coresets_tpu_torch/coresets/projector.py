"""Log-likelihood projectors: finite discretizations of the tangent space.

Port of ``bayesian_coresets_tpu/coresets/projector.py`` (reference
``bayesiancoresets/projector.py:4-32``).  A projector maps each datapoint
to a feature vector whose inner products approximate (or, for exact
families, equal) the Hilbert-space inner products between log-likelihood
functions.

- :class:`TangentFamily` — the pure-function protocol:
  ``make_ctx(gen, wts, pts)`` builds a projection context from the current
  coreset (posterior samples for black-box projectors, refit posterior
  factors for exact ones), ``project(ctx, query)`` maps query points to
  centered feature vectors, and the optional ``project_grad`` gives their
  gradients with respect to the query points.  ``make_ctx_warm`` and
  ``init_carry`` let context rebuilds carry state between calls within one
  build (e.g. the previous Laplace mode).
- :class:`FamilyProjector`/:class:`BlackBoxProjector` — the reference's
  stateful user API.  Samplers take a ``torch.Generator`` where the JAX
  package takes a key: ``sampler(gen, n_samples, wts, pts)``.  A projector
  lives on one device: its generator's, else ``device``, else the default
  device (the CUDA card); it places numpy inputs there and refuses tensors
  on another device.

Gradient projections are centered over the sample axis, as the JAX package
does (it departs from the reference there: PARITY.md C3).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils import config


class TangentFamily(NamedTuple):
    """Pure-function projector protocol.

    ``init_carry(wts, pts)`` must return a FULLY CONVERGED carry for the
    current coreset (it runs once per ``build()`` entry); ``make_ctx_warm``
    then refreshes it cheaply per step.
    """

    make_ctx: Callable                        # (gen, wts, pts) -> ctx
    project: Callable                         # (ctx, query_pts) -> (q, S) centered
    project_grad: Optional[Callable] = None   # (ctx, query_pts) -> (q, S, d)
    make_ctx_warm: Optional[Callable] = None  # (gen, wts, pts, carry) -> (ctx, carry)
    init_carry: Optional[Callable] = None     # (wts, pts) -> carry


def center_lls(lls: torch.Tensor) -> torch.Tensor:
    """Per-datum centering over samples (reference projector.py:21)."""
    return lls - torch.mean(lls, dim=1, keepdim=True)


def center_glls(glls: torch.Tensor) -> torch.Tensor:
    """Per-datum, per-coordinate centering over samples."""
    return glls - torch.mean(glls, dim=1, keepdim=True)


def blackbox_family(sampler, projection_dimension: int, loglikelihood,
                    grad_loglikelihood=None, warm_sampler=None,
                    init_carry=None) -> TangentFamily:
    """TangentFamily from a posterior sampler + log-likelihood (the
    functional core of the reference's BlackBoxProjector).

    ``warm_sampler(gen, n, wts, pts, carry) -> (samples, carry)`` plus
    ``init_carry(wts, pts) -> carry`` enable carried-state context rebuilds.
    """

    def make_ctx(gen, wts, pts):
        return sampler(gen, projection_dimension, wts, pts)

    def project(ctx, pts):
        return center_lls(loglikelihood(pts, ctx))

    project_grad = None
    if grad_loglikelihood is not None:
        def project_grad(ctx, pts):  # noqa: F811
            return center_glls(grad_loglikelihood(pts, ctx))

    make_ctx_warm = None
    if warm_sampler is not None:
        if init_carry is None:
            raise ValueError("warm_sampler requires init_carry")

        def make_ctx_warm(gen, wts, pts, carry):  # noqa: F811
            return warm_sampler(gen, projection_dimension, wts, pts, carry)

    return TangentFamily(make_ctx, project, project_grad, make_ctx_warm, init_carry)


def project(family: TangentFamily, ctx, pts: torch.Tensor, grad: bool = False):
    """Centered projections, and with ``grad`` also their gradients."""
    lls = family.project(ctx, pts)
    if not grad:
        return lls
    if family.project_grad is None:
        raise ValueError("grad projection requested but not provided")
    return lls, family.project_grad(ctx, pts)


class Projector:
    """Abstract stateful projector (reference projector.py:4-9)."""

    def project(self, pts, grad: bool = False):
        raise NotImplementedError

    def update(self, wts, pts):
        raise NotImplementedError


class FamilyProjector(Projector):
    """Stateful facade over any TangentFamily (ctx held between calls).

    ``generator`` plays the part of the JAX package's ``_key``: every
    ``update`` draws from it, so repeated updates draw fresh samples.
    Without one, the projector makes its own on ``device`` (default: the
    default device), seeded with 0.
    """

    def __init__(self, family: TangentFamily,
                 generator: torch.Generator | None = None, device=None):
        self.family = family
        if generator is None:
            dev = config.resolve_device(device) if device is not None else config.default_device()
            generator = torch.Generator(device=dev).manual_seed(0)
        self.device = config.resolve_device(generator.device)
        if device is not None and config.resolve_device(device) != self.device:
            raise ValueError(f"generator on {self.device} but device={device}")
        self._gen = generator
        self._ctx = None
        self.update(torch.zeros((0,), device=self.device), torch.zeros((0, 0), device=self.device))

    def _place(self, x, what):
        return config.on_device(x, None, self.device, what)

    def update(self, wts, pts):
        """Rebuild the projection context from the current coreset."""
        self._ctx = self.family.make_ctx(self._gen, self._place(wts, "wts"),
                                         self._place(pts, "pts"))

    def project(self, pts, grad: bool = False):
        return project(self.family, self._ctx, self._place(pts, "pts"), grad=grad)


class BlackBoxProjector(FamilyProjector):
    """Sampler + log-likelihood discretizer (reference projector.py:11-32)."""

    def __init__(self, sampler, projection_dimension: int, loglikelihood,
                 grad_loglikelihood=None, generator: torch.Generator | None = None,
                 warm_sampler=None, init_carry=None, device=None):
        self.projection_dimension = int(projection_dimension)
        family = blackbox_family(sampler, self.projection_dimension, loglikelihood,
                                 grad_loglikelihood, warm_sampler=warm_sampler,
                                 init_carry=init_carry)
        super().__init__(family, generator=generator, device=device)

    @property
    def samples(self):
        return self._ctx
