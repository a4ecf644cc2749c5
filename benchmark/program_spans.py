"""The program's own spans (``bayesian_coresets_tpu_torch.utils.profiling``)
over a stretch of whole jobs, read by the metrics that time the layers
inside a build.

On its first call in a run it runs the cell's ``trace_jobs`` jobs once more,
after the traced stretch and outside any profiler, with the program's span
recording on, and keeps on the job: the spans, each job's wall seconds and
the solver iterations run (``snnls.itrs_run``).  Their indices follow the
traced stretch's, past the window, so the check never samples them; the
readers that come earlier in ``BENCHMARK.json`` have read before they run.
A program without the span recorder gives None, and so do its readers.
"""

from __future__ import annotations

import sys
import time

from .harness import sync

_MISSING = object()


def collect(ctx, log=sys.stderr):
    """{"spans", "job_s", "itrs", "jobs"}, or None where the program records
    no spans or the job is not a Hilbert build's."""
    got = getattr(ctx.job, "program_spans", _MISSING)
    if got is _MISSING:
        got = ctx.job.program_spans = _collect(ctx, log)
    return got


def _collect(ctx, log):
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import profiling

    if ctx.job.kind != "hilbert" or not hasattr(profiling, "enable"):
        return None
    n = ctx.cell.check["trace_jobs"]
    first = ctx.window.attempted + n
    job_s = []
    profiling.reset()
    profiling.enable()
    try:
        itrs0 = snnls.itrs_run
        for i in range(first, first + n):
            t0 = time.perf_counter()
            ctx.job.run(i)
            sync(ctx.job.dev)
            job_s.append(time.perf_counter() - t0)
        itrs = snnls.itrs_run - itrs0
        spans = profiling.spans()
    finally:
        profiling.disable()
        profiling.reset()
    print(f"program_spans: {n} jobs from {first}, seconds {job_s}, "
          f"{len(spans)} spans, {itrs} iterations", file=log, flush=True)
    return {"spans": spans, "job_s": job_s, "itrs": itrs, "jobs": n}


def named(spans, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def under(spans, name: str, root: str) -> list:
    """The spans ``name`` that have a span ``root`` among their ancestors."""
    out = []
    for s in named(spans, name):
        p = s["parent"]
        while p is not None and spans[p]["name"] != root:
            p = spans[p]["parent"]
        if p is not None:
            out.append(s)
    return out


def device_s(spans) -> float:
    """The spans' device intervals summed (those that have one)."""
    return sum(s["dev_end"] - s["dev_start"] for s in spans if s["dev_end"] is not None)


def host_s(spans) -> float:
    return sum(s["host_end"] - s["host_start"] for s in spans)
