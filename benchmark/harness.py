"""The benchmark's run: resolve a cell from ``BENCHMARK.json`` to its files,
set it up, measure a window of whole jobs, read the metrics, check the
answers against the plain reference, and assemble the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration's sizes (its ``file``);
- ``workloads/<traffic>.json``: the traffic mix, whose ``job`` names the
  kind of job (``jobs/<job>.py``) that runs it; a configuration's ``model``
  names its model (``models/<model>.py``) for the jobs that run one;
- ``cells/<cell>.json``: what the check of that cell samples, and the limit
  of each number it compares;
- ``metrics/<metric>.py``: a reader, ``read(ctx)``, that returns the
  metric's value from the run's window, spans, counters or trace, or None
  where it finds nothing to read (the metric is then left out); a reader
  that can read only on a card says so by ``CARD_ONLY = True``.

A job or a model named by a dotted module path in place of a plain name is
imported by that path.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import stats, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesian_coresets_tpu")


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list


def load_spec(path: Path = SPEC) -> dict:
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, name: str, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, check and
    metrics; raises KeyError for a name the spec does not hold.  ``here``
    holds the ``workloads/`` and ``cells/`` files."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {SPEC.name}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, entry=entry,
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads((here / "workloads" / f"{entry['traffic']}.json").read_text()),
        check=json.loads((here / "cells" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark (a job, a model), or the module
    at ``name`` where it is a dotted path."""
    return importlib.import_module(name if "." in name else f"benchmark.{kind}.{name}")


def job_module(traffic: dict):
    return module("jobs", traffic["job"])


def metric_module(metric: str):
    """``metrics/<metric>.py``, loaded anew."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return metric_module(metric).read


def card_only(metric: str) -> bool:
    """Whether the metric's reader can read only on a card."""
    return getattr(metric_module(metric), "CARD_ONLY", False)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Context:
    """What a metric's reader reads."""

    cell: Cell
    job: object
    window: stats.Window
    setup_s: float
    trace: tracing.Trace | None = None
    counters: dict = field(default_factory=dict)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_window(job, seconds: float, spans: bool, dev: torch.device, log=sys.stderr):
    """Jobs 0, 1, ... back to back until ``seconds`` have passed; the job
    running then finishes.  Returns the :class:`stats.Window`."""
    win = stats.Window()
    sync(dev)
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            work = job.run(i, spans=spans)
        except Exception as e:      # a failed job counts and the window goes on
            sync(dev)
            win.failed += 1
            work = 0
            if win.failed == 1:
                import traceback
                traceback.print_exc(file=log)
            print(f"job {i} failed: {type(e).__name__}: {e}", file=log, flush=True)
        t1 = time.perf_counter()
        win.durations.append(t1 - t0)
        win.work.append(work)
        i += 1
        if t1 - start >= seconds:
            win.seconds = t1 - start
            return win


def _counters() -> dict:
    from bayesian_coresets_tpu_torch.ops import graphs
    return {"captures": graphs.captures, "capture_s": graphs.capture_s + graphs.instantiate_s}


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        t_start: float, log=sys.stderr) -> tuple[dict, dict]:
    """One run of ``cell``: (the result line's dict, the details of its
    check).  ``t_start`` is the process's start on the host clock."""
    if dev.type == "cuda":
        from bayesian_coresets_tpu_torch.ops import _cuda_build
        _cuda_build.load_library()
    job = job_module(cell.traffic).Job(cell.config, cell.traffic, cell.check, seed, dev)
    job.warm()
    sync(dev)
    setup_s = time.perf_counter() - t_start
    before = _counters()
    win = run_window(job, seconds, trace, dev, log)
    after = _counters()
    ctx = Context(cell, job, win, setup_s,
                  counters={k: after[k] - before[k] for k in after})
    if trace:
        n0 = win.attempted
        with tracing.traced(dev) as got:
            for j in range(cell.check["trace_jobs"]):
                job.run(n0 + j)
        ctx.trace = got[0]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    completed = [i for i in range(win.attempted) if i in job.answers]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, seen = job.check(completed) if completed else ({}, {})
    checks = {k: {"value": v, "limit": cell.check["limits"][k]} for k, v in numbers.items()}
    correct = (bool(checks) and win.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.entry["chips"], "memory_peak_bytes": peak}
    if trace:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    durs = sorted(win.durations)
    return result, {"seen": seen, "counters": ctx.counters, "window_s": win.seconds,
                    "job_s": {"min": durs[0], "median": durs[len(durs) // 2], "max": durs[-1]},
                    "check_s": time.perf_counter() - t_check}
