"""The arithmetic of a measured window: whole jobs run back to back by one
caller, from the first job's start to the last job's synchronized end."""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field


@dataclass
class Window:
    """The window's jobs: each one's wall seconds and its work (points of a
    coreset built, samples drawn), in the order they ran, and the window's
    own seconds.  A job that raised counts as attempted and failed, with its
    seconds and no work."""

    seconds: float = 0.0
    durations: list = field(default_factory=list)
    work: list = field(default_factory=list)
    failed: int = 0

    @property
    def attempted(self) -> int:
        return len(self.durations)

    def rate(self) -> float | None:
        """All the work of the window's completed jobs over its seconds."""
        if self.seconds <= 0 or not self.durations:
            return None
        return sum(self.work) / self.seconds

    def percentile_ms(self, q: int) -> float | None:
        """The q-th percentile of every job's wall time, in ms: linear
        interpolation between the order statistics (``statistics.quantiles``,
        method ``inclusive``).  Needs two jobs or more."""
        if len(self.durations) < 2:
            return None
        return 1e3 * statistics.quantiles(self.durations, n=100, method="inclusive")[q - 1]

