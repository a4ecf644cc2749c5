"""Coreset construction API (Hilbert coresets and projectors)."""

from .coreset import Coreset
from .hilbert import HilbertCoreset
from .projector import (
    BlackBoxProjector,
    FamilyProjector,
    Projector,
    TangentFamily,
    blackbox_family,
    center_lls,
)

__all__ = [
    "Coreset",
    "HilbertCoreset",
    "Projector",
    "FamilyProjector",
    "BlackBoxProjector",
    "TangentFamily",
    "blackbox_family",
    "center_lls",
]
