"""Log-likelihood projectors: finite discretizations of the tangent space.

Port of ``bayesian_coresets_tpu/coresets/projector.py:61-168`` (reference
``bayesiancoresets/projector.py:4-32``).  A projector maps each datapoint
to a feature vector whose inner products approximate the Hilbert-space
inner products between log-likelihood functions.

- :class:`TangentFamily` — the pure-function protocol:
  ``make_ctx(gen, wts, pts)`` builds a projection context (posterior
  samples for black-box projectors) and ``project(ctx, query)`` maps query
  points to centered feature vectors.
- :class:`FamilyProjector`/:class:`BlackBoxProjector` — the reference's
  stateful user API.  Samplers take a ``torch.Generator`` where the JAX
  package takes a key: ``sampler(gen, n_samples, wts, pts)``.

Gradient projections and warm-carried contexts are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class TangentFamily(NamedTuple):
    """Pure-function projector protocol."""

    make_ctx: Callable                 # (gen, wts, pts) -> ctx
    project: Callable                  # (ctx, query_pts) -> (q, S) centered


def center_lls(lls: torch.Tensor) -> torch.Tensor:
    """Per-datum centering over samples (reference projector.py:21)."""
    return lls - torch.mean(lls, dim=1, keepdim=True)


def blackbox_family(sampler, projection_dimension: int,
                    loglikelihood) -> TangentFamily:
    """TangentFamily from a posterior sampler + log-likelihood (the
    functional core of the reference's BlackBoxProjector)."""

    def make_ctx(gen, wts, pts):
        return sampler(gen, projection_dimension, wts, pts)

    def project(ctx, pts):
        return center_lls(loglikelihood(pts, ctx))

    return TangentFamily(make_ctx, project)


class Projector:
    """Abstract stateful projector (reference projector.py:4-9)."""

    def project(self, pts):
        raise NotImplementedError

    def update(self, wts, pts):
        raise NotImplementedError


class FamilyProjector(Projector):
    """Stateful facade over any TangentFamily (ctx held between calls).

    ``generator`` plays the part of the JAX package's ``_key``: every
    ``update`` draws from it, so repeated updates draw fresh samples.
    """

    def __init__(self, family: TangentFamily,
                 generator: torch.Generator | None = None):
        self.family = family
        self._gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self._ctx = None
        self.update(torch.zeros((0,)), torch.zeros((0, 0)))

    def update(self, wts, pts):
        """Rebuild the projection context from the current coreset."""
        self._ctx = self.family.make_ctx(self._gen, wts, pts)

    def project(self, pts):
        return self.family.project(self._ctx, pts)


class BlackBoxProjector(FamilyProjector):
    """Sampler + log-likelihood discretizer (reference projector.py:11-32)."""

    def __init__(self, sampler, projection_dimension: int, loglikelihood,
                 generator: torch.Generator | None = None):
        self.projection_dimension = int(projection_dimension)
        family = blackbox_family(sampler, self.projection_dimension,
                                 loglikelihood)
        super().__init__(family, generator=generator)

    @property
    def samples(self):
        return self._ctx
