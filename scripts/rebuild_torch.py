#!/usr/bin/env python3
"""A Hilbert build and a rebuild of the same shape on fresh data, on one CUDA card.

    python3 scripts/rebuild_torch.py [--root DIR] [--rebuilds 3] [--steps 50,450] [--drop]

Runs the port found at ``--root`` (default: this checkout; give another
version's unpacked tree to compare two versions in one process each, in
turns on one card).  bench.py's flagship build (logistic N=100k, D=10,
S=500 samples theta ~ 0.1 N(0, I), int8 select, max_active=1024, M=500 as
``build(50)`` then ``build(450)``, or as the calls of ``--steps``: a
driver's walk over ``coreset_size_grid(500, 7, "log")`` is
``0,1,1,5,15,40,115,322``), then ``--rebuilds`` builds on fresh
projections of the same shape (the projector's generator seeded 2, 3, ...,
as bench.py's fresh keys), each while the first coreset lives, or with
``--drop`` after the coresets before it are gone (as a driver's runs, one
after another, on data of one shape).  Prints one
JSON line per build: projection and build seconds, points/s, graphs
captured and their capture and instantiate seconds, constants copied into
static copies (where the version has them), the peak allocation of the
build, the error at M, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rebuilds", type=int, default=3)
    ap.add_argument("--steps", default="50,450")
    ap.add_argument("--drop", action="store_true")
    args = ap.parse_args()
    steps = [int(k) for k in args.steps.split(",")]
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import graphs

    if not torch.cuda.is_available():
        raise SystemExit("rebuild_torch: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    N, D, S, M = 100_000, 10, 500, sum(steps)

    def sampler(gen, n, wts, pts):
        return 0.1 * torch.randn((n, D), generator=gen, device=gen.device)

    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), N, D)
    keep = []
    for k in range(1 + args.rebuilds):
        proj = bc.BlackBoxProjector(sampler, S, logistic.log_likelihood,
                                    generator=torch.Generator(device=dev).manual_seed(1 + k))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        caps, cap_s, inst_s = graphs.captures, graphs.capture_s, graphs.instantiate_s
        loads = getattr(graphs, "loads", None)
        t0 = time.perf_counter()
        c = bc.HilbertCoreset(Z, proj, select_dtype=torch.int8, max_active=1024)
        torch.cuda.synchronize()
        t_proj = time.perf_counter() - t0
        t0 = time.perf_counter()
        for itrs in steps:
            c.build(itrs)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        if not args.drop:
            keep.append(c)
        print(json.dumps({
            "root": args.root, "build": "first" if k == 0 else f"rebuild_{k}",
            "projection_s": t_proj, "build_s": t_build, "points_per_s": M / (t_proj + t_build),
            "graphs_captured": graphs.captures - caps,
            "capture_s": graphs.capture_s - cap_s, "instantiate_s": graphs.instantiate_s - inst_s,
            "constants_copied": None if loads is None else graphs.loads - loads,
            "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
            "err": c.error() / float(c.snnls.consts.bnorm), "steps": args.steps,
            "drop": args.drop, "card": card}), flush=True)
        del c
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
