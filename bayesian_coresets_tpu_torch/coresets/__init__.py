"""Coreset construction API: Hilbert coresets, SparseVI, BatchPSVI, uniform
sampling, and the projectors and tangent families they consume."""

from .bpsvi import BatchPSVICoreset
from .coreset import Coreset
from .exact import gaussian_tangent_family, identity_tangent_family, linreg_tangent_family
from .hilbert import HilbertCoreset
from .projector import (
    BlackBoxProjector,
    FamilyProjector,
    Projector,
    TangentFamily,
    blackbox_family,
    center_glls,
    center_lls,
    project,
)
from .sampling import UniformSamplingCoreset
from .sparsevi import SparseVICoreset

__all__ = [
    "Coreset",
    "HilbertCoreset",
    "SparseVICoreset",
    "BatchPSVICoreset",
    "UniformSamplingCoreset",
    "Projector",
    "FamilyProjector",
    "BlackBoxProjector",
    "TangentFamily",
    "blackbox_family",
    "center_lls",
    "center_glls",
    "project",
    "gaussian_tangent_family",
    "identity_tangent_family",
    "linreg_tangent_family",
]
