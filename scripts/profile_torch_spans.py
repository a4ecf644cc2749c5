#!/usr/bin/env python3
"""Where a benchmark cell's Hilbert builds spend their time, read from the
port's own spans (``utils/profiling.py``: CUDA events, no profiler), on one
CUDA card.

    python3 scripts/profile_torch_spans.py builds --workload lr100k.giga --seed N
        [--seconds 25] [--profiled_jobs K] [--slow_ms 140] [--out FILE]
    python3 scripts/profile_torch_spans.py cost --workload lr100k.giga --seed N
        [--seconds 51] [--order off,on,host,host,on,off] [--out FILE]

``builds``: span recording on from the process's start (before the data and
the warm-up build), then a window of the cell's builds back to back; per
build (one JSON line each in ``--out``): ``hilbert.solve``'s device ms, the
ms inside its replayed graphs (``graphs.replay``) and between them, the
in-graph ms by piece key, the reads, captures, projection and constants.
The last line of standard output splits the builds at ``--slow_ms`` of wall
time and gives each group's medians.  ``--profiled_jobs K`` first runs K
builds under ``torch.profiler`` (as the benchmark's traced stretch does).

``cost``: after a 10 s warm-up window, windows of ``--seconds`` each in one
process, in the order given: ``off`` (no recording), ``on`` (spans with
their CUDA events), ``host`` (spans without events); one JSON line each
with the window's points per second and median build.  It first prints the
host microseconds of one empty span on the card, with and without events.

``--toy`` runs the cell cut to a toy size on the CPU (a rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bayesian_coresets_tpu_torch.utils import profiling  # noqa: E402

NAMES = ("hilbert.init", "hilbert.project", "hilbert.consts", "hilbert.solve", "hilbert.active")


def _job(args):
    """(the cell's job, warmed up, and its device)."""
    from benchmark import harness
    if args.toy:
        from benchmark.tests.toy import toy_cell
        dev, cell = torch.device("cpu"), toy_cell(args.workload)
    else:
        dev = torch.device("cuda", 0)
        cell = harness.resolve(harness.load_spec(), args.workload)
        from bayesian_coresets_tpu_torch.ops import _cuda_build
        _cuda_build.load_library()
    job = harness.job_module(cell.traffic).Job(cell.config, cell.traffic, cell.check, args.seed, dev)
    job.warm()
    harness.sync(dev)
    return job, dev


def per_build(recs) -> list[dict]:
    """The spans of each coreset (by its serial), in order, summed: ms."""
    by = defaultdict(lambda: {"graphs.replay": [], "snnls.read": [], "graphs.capture": []})
    for r in recs:
        if r["coreset"] is None:
            continue
        b = by[r["coreset"]]
        if r["name"] in NAMES:
            b[r["name"]] = r
        elif r["name"] in b:
            b[r["name"]].append(r)

    def dev(r):
        return 1e3 * (r["dev_end"] - r["dev_start"])

    def host(r):
        return 1e3 * (r["host_end"] - r["host_start"])

    out = []
    for c, b in sorted(by.items()):
        if "hilbert.solve" not in b:
            continue
        replays = b["graphs.replay"]
        keys = defaultdict(float)
        for r in replays:
            keys[str(r["attrs"]["key"])] += dev(r)
        inside = sum(dev(r) for r in replays)
        solve = dev(b["hilbert.solve"])
        out.append({
            "coreset": c, "solve_dev_ms": solve, "solve_host_ms": host(b["hilbert.solve"]),
            "in_graph_ms": inside, "off_graph_ms": solve - inside, "replays": len(replays),
            "gap_ms": sum(1e3 * (n["dev_start"] - p["dev_end"])
                          for p, n in zip(replays, replays[1:])),
            "reads": len(b["snnls.read"]),
            "read_host_ms": sum(host(r) for r in b["snnls.read"]),
            "captures": len(b["graphs.capture"]),
            "capture_host_ms": sum(host(r) for r in b["graphs.capture"]),
            "project_ms": dev(b["hilbert.project"]) if "hilbert.project" in b else None,
            "consts_ms": dev(b["hilbert.consts"]) if "hilbert.consts" in b else None,
            "by_key": dict(keys)})
    return out


def builds(args) -> None:
    from benchmark import harness
    t0 = time.perf_counter()
    profiling.enable()
    job, dev = _job(args)
    if args.profiled_jobs:
        from benchmark import tracing
        with tracing.traced(dev):
            for j in range(args.profiled_jobs):
                job.run(10_000 + j)
    at = time.perf_counter() - t0
    win = harness.run_window(job, args.seconds, False, dev)
    recs = profiling.spans()
    found = per_build(recs)
    warm, found = found[0], found[1 + args.profiled_jobs:]
    for b, d in zip(found, win.durations):
        b["wall_ms"], b["at_s"] = 1e3 * d, at
        at += d
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        head = {"warm": warm, "records": len(recs), "dropped": profiling.dropped,
                "window_s": win.seconds, "builds": len(found)}
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in [head] + found))
    groups = {"slow": [b for b in found if b["wall_ms"] > args.slow_ms],
              "fast": [b for b in found if b["wall_ms"] <= args.slow_ms]}
    summary = {"seed": args.seed, "builds": len(found), "slow": len(groups["slow"]),
               "fast": len(groups["fast"]),
               "first_fast_build": next((i for i, b in enumerate(found)
                                         if b["wall_ms"] <= args.slow_ms), None)}
    for name, group in groups.items():
        if not group:
            continue
        for k in ("wall_ms", "solve_dev_ms", "in_graph_ms", "off_graph_ms", "gap_ms",
                  "read_host_ms", "capture_host_ms", "project_ms", "consts_ms"):
            summary[f"{name}.{k}"] = round(statistics.median(b[k] for b in group), 4)
        keys = sorted({k for b in group for k in b["by_key"]})
        summary[f"{name}.by_key"] = {
            k: round(statistics.median(b["by_key"].get(k, 0.0) for b in group), 4) for k in keys}
    print(json.dumps(summary), flush=True)


def _empty_span_us(dev, events: bool, n: int = 20_000) -> float:
    profiling.reset()
    profiling.enable()
    if not events:
        profiling._refs.clear()
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("empty", device=dev):
            pass
    us = 1e6 * (time.perf_counter() - t0) / n
    profiling.spans()
    profiling.disable()
    profiling.reset()
    return us


def cost(args) -> None:
    from benchmark import harness
    job, dev = _job(args)
    harness.run_window(job, 10.0, False, dev)
    if dev.type == "cuda":
        for events in (True, False):
            print(json.dumps({"span_host_us": _empty_span_us(dev, events), "events": events}),
                  flush=True)
    lines = []
    for mode in args.order.split(","):
        if mode in ("on", "host"):
            profiling.reset()
            profiling.enable()
            if mode == "host":              # records without their timing events
                profiling._refs.clear()
        win = harness.run_window(job, args.seconds, False, dev)
        line = {"mode": mode, "points_per_s": win.rate(), "builds": win.attempted,
                "median_build_ms": 1e3 * statistics.median(win.durations)}
        if mode in ("on", "host"):
            t0 = time.perf_counter()
            line["spans_per_build"] = len(profiling.spans()) / max(win.attempted, 1)
            line["resolve_s"] = time.perf_counter() - t0
            profiling.disable()
            profiling.reset()
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("builds", "cost"))
    p.add_argument("--workload", default="lr100k.giga")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float)
    p.add_argument("--profiled_jobs", type=int, default=0)
    p.add_argument("--slow_ms", type=float, default=140.0)
    p.add_argument("--order", default="off,on,host,host,on,off")
    p.add_argument("--out")
    p.add_argument("--toy", action="store_true")
    args = p.parse_args(argv)
    if args.seconds is None:
        args.seconds = 25.0 if args.mode == "builds" else 51.0
    (builds if args.mode == "builds" else cost)(args)


if __name__ == "__main__":
    main()
