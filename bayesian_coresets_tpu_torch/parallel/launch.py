"""Run one function on k local ranks.

In JAX one process drives a mesh of local devices; in PyTorch a mesh of k
ranks is k processes.  :func:`run_local` starts them with the ``spawn``
start method (a fresh interpreter each: a card is never shared with a
forked parent's context), joins them to one process group through a file
(no port to pick), runs ``fn(*args)`` on every rank, and returns the
ranks' results in rank order.  A rank that raises or dies ends the others
and its traceback is raised here.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback


def _rank_main(fn, args, rank: int, world_size: int, backend: str, init_file: str,
               results):
    import torch
    import torch.distributed as dist

    from .distributed import initialize

    if not torch.cuda.is_available():
        torch.set_num_threads(1)       # k ranks share the host's cores
    try:
        initialize(f"file://{init_file}", world_size, rank, backend)
        out = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_local(fn, world_size: int, backend: str, init_file: str, args=(),
              timeout: float = 1800.0) -> list:
    """``fn(*args)`` on ``world_size`` spawned ranks; their results in rank
    order.  ``fn`` and ``args`` must pickle (a module-level function).
    ``init_file`` is a path that no other group uses at the same time (it
    must not exist yet).  Each rank calls :func:`.distributed.initialize`
    with ``backend`` (so a card is set as its device) and, on the CPU,
    ``torch.set_num_threads(1)``.  Raises ``RuntimeError`` with the
    traceback of the first rank that fails, after ending the others."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world_size, backend, init_file, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size and failure is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode != 0]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks did not finish within {timeout} s"
                continue
            if ok:
                out[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world_size)]
