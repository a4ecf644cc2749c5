"""PRNG discipline helpers.

Port of ``bayesian_coresets_tpu/utils/prng.py``.  The reference relies on a
single global NumPy stream seeded per trial (reference:
examples/gaussian/main.py:44); the JAX package threads ``jax.random`` keys.
Here each stage of a run gets a seeded ``torch.Generator`` of its own,
whose seed is derived from ``(trial, *tags)`` by NumPy's ``SeedSequence``:
the same tags give the same stream on every run and device count, and
other tags give independent ones.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config


def derive_seed(trial: int, *tags: int) -> int:
    """A 63-bit seed that depends on ``trial`` and every tag, in order (the
    tag count leads the words: ``SeedSequence`` ignores trailing zeros)."""
    words = [int(t) % (1 << 64) for t in (len(tags), trial, *tags)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def fold_seed(trial: int, *tags: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default: the default device) seeded from
    an integer trial id plus stage tags."""
    dev = config.resolve_device(device) if device is not None else config.default_device()
    return torch.Generator(device=dev).manual_seed(derive_seed(trial, *tags))


def split_like(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``gen``'s device derived from its seed (not from
    its current state: like a JAX key split, the result depends only on
    what ``gen`` was seeded with)."""
    seed = gen.initial_seed()
    return [torch.Generator(device=gen.device).manual_seed(derive_seed(seed, i))
            for i in range(int(n))]
