"""Phase timing and device traces.

Port of ``bayesian_coresets_tpu/utils/profiling.py``: named phase timers
in one registry (wall seconds and call counts), and :func:`trace`, the
``torch.profiler`` counterpart of the JAX package's ``xla_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_PHASES: dict[str, list[float]] = defaultdict(list)


def _cuda_devices(sync) -> set[torch.device]:
    """The CUDA devices that ``sync`` names: a tensor's, a device, or those
    of the tensors in a tuple, list or NamedTuple of them."""
    if isinstance(sync, torch.Tensor):
        sync = sync.device
    if isinstance(sync, torch.device):
        return {sync} if sync.type == "cuda" else set()
    if isinstance(sync, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in sync))
    return set()


@contextlib.contextmanager
def phase(name: str, sync=None):
    """Time a named phase.  ``sync`` (a CUDA tensor or device, or a tuple
    of tensors): synchronize its device before stopping the clock, so the
    time includes the device work the phase queued."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for dev in _cuda_devices(sync):
            torch.cuda.synchronize(dev)
        _PHASES[name].append(time.perf_counter() - t0)


def report() -> dict[str, dict[str, float]]:
    """Aggregate phase timings: {name: {count, total_s, mean_s}}."""
    return {name: {"count": len(t), "total_s": sum(t), "mean_s": sum(t) / len(t)}
            for name, t in _PHASES.items()}


def reset() -> None:
    _PHASES.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the CUDA
    card where there is one) and write a Chrome trace into ``logdir``
    (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
