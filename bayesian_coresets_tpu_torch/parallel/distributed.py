"""Process-group initialization: one process per GPU.

Port of ``bayesian_coresets_tpu/parallel/distributed.py``.  JAX's
multi-controller model wires every host's devices into one global view;
here every rank is a process (``torchrun --nproc-per-node k``, or
:func:`.launch.run_local`) and ``initialize`` joins it to the default
process group.  Nothing picks a backend behind the caller's back: NCCL for
the card, gloo for the CPU, or what ``backend`` names, and a backend that
is not there raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> int:
    """Join the default process group (a no-op when one is up) and return
    its size.

    ``init_method`` defaults to ``env://`` (the ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` that ``torchrun`` sets);
    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``.
    ``backend``: ``"nccl"`` where there is a card, else ``"gloo"``.  With a
    card the rank's device is set to ``LOCAL_RANK`` (else the rank) modulo
    the card count, so ranks sharing a card (gloo) all use it.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if backend not in available:
        raise ValueError(f"backend must be 'nccl' or 'gloo'; got {backend!r}")
    if not available[backend]():
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available in "
                           "this PyTorch build")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size


def local_data_shard(n: int) -> slice:
    """Rows of a length-n dataset that this rank owns under the data
    layout of :func:`.streamed.streamed_row_layout` (contiguous blocks of
    ceil(n / world) rows): the rows this rank loads."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = -(-n // world)
    return slice(min(rank * per, n), min((rank + 1) * per, n))
