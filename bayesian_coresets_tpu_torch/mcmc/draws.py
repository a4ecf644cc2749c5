"""The samplers' random draws, named by the role each plays.

JAX threads a key through every kernel and splits it; the port's kernels
ask a draw source instead, one method per role, each for all C chains at
once.  :class:`Draws` is backed by a ``torch.Generator`` and is what the
samplers use.  Any object with the same methods serves: the tests give the
kernels a source that replays, role by role, the draws ``jax.random`` makes
from a key, so that one transition can be held against the JAX kernel.

NUTS takes its draws where the host's reads cannot move them: per
doubling, when it begins, the direction, the uniform of the proposal
across doublings and one (2^j, C) block of leaf uniforms, whether or not
the subtree runs to its end.  So a transition consumes the generator
alike whether its leaves run one at a time with a read after each or in
segments of several (replayed CUDA graphs, ``nuts.py``).
"""

from __future__ import annotations

import torch


class Draws:
    """Draws from ``gen``, made on its device, which must be the chains'
    device: a copy from another device inside a captured CUDA graph would
    replay one set of draws forever, so a CPU generator driving CUDA chains
    raises (and so does a CUDA generator driving CPU chains)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def _on(self, device) -> torch.device:
        device, gd = torch.device(device), self.gen.device
        if gd.type != device.type or None not in (gd.index, device.index) \
                and gd.index != device.index:
            raise ValueError(f"the generator is on {gd}, the chains on {device}: give the "
                             "sampler a torch.Generator on the chains' device")
        return gd

    def _rand(self, n: int, device) -> torch.Tensor:
        return torch.rand((n,), generator=self.gen, device=self._on(device))

    def momentum(self, shape, dtype, device) -> torch.Tensor:
        """Standard normals (C, d) behind the momentum."""
        return torch.randn(shape, generator=self.gen, dtype=dtype, device=self._on(device))

    def direction(self, n: int, device) -> torch.Tensor:
        """(C,) bool: extend the NUTS trajectory forward in time."""
        return self._rand(n, device) < 0.5

    def leaf_uniforms(self, L: int, n: int, device) -> torch.Tensor:
        """(L, C) uniforms of the multinomial proposal within a subtree of
        L leaves, row k for leaf k."""
        return torch.rand((L, n), generator=self.gen, device=self._on(device))

    def tree_uniform(self, n: int, device) -> torch.Tensor:
        """(C,) uniforms of the biased proposal across doublings."""
        return self._rand(n, device)

    def accept_uniform(self, n: int, device) -> torch.Tensor:
        """(C,) uniforms of HMC's Metropolis correction."""
        return self._rand(n, device)

    def num_steps(self, n: int, high: int, device) -> torch.Tensor:
        """(C,) int64 trajectory lengths, uniform in [1, high]."""
        return torch.randint(1, high + 1, (n,), generator=self.gen, device=self._on(device))


class BlockDraws:
    """This rank's block of chains [lo, lo + n) out of C: every draw is made
    for all C chains from ``source`` and the block kept, so ranks whose
    generators start alike stay in step and draw what one process drawing
    for every chain draws (``parallel/mcmc.py``)."""

    def __init__(self, source, lo: int, C: int):
        self.source, self.lo, self.C = as_draws(source), lo, C

    def _block(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return x[self.lo:self.lo + n]

    def momentum(self, shape, dtype, device) -> torch.Tensor:
        full = self.source.momentum((self.C,) + tuple(shape[1:]), dtype, device)
        return self._block(full, shape[0])

    def direction(self, n: int, device) -> torch.Tensor:
        return self._block(self.source.direction(self.C, device), n)

    def leaf_uniforms(self, L: int, n: int, device) -> torch.Tensor:
        return self.source.leaf_uniforms(L, self.C, device)[:, self.lo:self.lo + n]

    def tree_uniform(self, n: int, device) -> torch.Tensor:
        return self._block(self.source.tree_uniform(self.C, device), n)

    def accept_uniform(self, n: int, device) -> torch.Tensor:
        return self._block(self.source.accept_uniform(self.C, device), n)

    def num_steps(self, n: int, high: int, device) -> torch.Tensor:
        return self._block(self.source.num_steps(self.C, high, device), n)


def as_draws(source) -> Draws:
    """A ``torch.Generator`` becomes a :class:`Draws`; a draw source is kept."""
    return Draws(source) if isinstance(source, torch.Generator) else source
