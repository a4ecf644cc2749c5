"""Inputs of the benchmark, made from ``--seed``: the data and the projection
samples.  Both sides of a check, the program and the plain reference, are
handed what this module makes.

Every draw comes from a ``torch.Generator`` on the run's device, seeded by
:func:`subseed` from the run's seed and the purpose of the draw, so the same
seed gives the same inputs and two purposes never share a stream.  What a
data set's rows are is its model's (``models/<model>.py``'s ``rows``).
"""

from __future__ import annotations

import numpy as np
import torch

GEN_BLOCK_ROWS = 1 << 20  # rows drawn per block of a large data set


def subseed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose of one run: ``purpose`` is a tuple of
    small non-negative integers (a stream number, a job index)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *map(int, purpose)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint64)
    return int((int(state[0]) << 32 ^ int(state[1])) & 0x7FFFFFFFFFFFFFFF)


# stream numbers of :func:`subseed`
DATA, THETA, WARM_THETA, CHECK = 1, 2, 3, 4


def generator(dev: torch.device, seed: int, *purpose) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(subseed(seed, *purpose))


def dataset(rows, seed: int, n: int, dev: torch.device, on_host: bool):
    """The run's data set of ``n`` rows drawn by ``rows(gen, k)`` (k rows,
    f32 on the generator's device): a tensor on ``dev``, or with ``on_host``
    a numpy array drawn on ``dev`` in blocks and kept in host memory (the
    streamed configuration's data, which stays off the card)."""
    gen = generator(dev, seed, DATA)
    if not on_host:
        return rows(gen, n)
    out = None
    for lo in range(0, n, GEN_BLOCK_ROWS):
        hi = min(n, lo + GEN_BLOCK_ROWS)
        block = rows(gen, hi - lo).cpu().numpy()
        if out is None:
            out = np.empty((n, block.shape[1]), dtype=block.dtype)
        out[lo:hi] = block
    return out


def projection_samples(seed: int, index: int, S: int, d: int, scale: float,
                       dev: torch.device, stream: int = THETA) -> torch.Tensor:
    """The S projection samples of job ``index``: theta ~ scale * N(0, I),
    (S, d) f32 on ``dev`` (bench.py:97's sampler, a fresh draw per build)."""
    gen = generator(dev, seed, stream, index)
    return scale * torch.randn((S, d), generator=gen, dtype=torch.float32, device=dev)
