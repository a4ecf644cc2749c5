#!/usr/bin/env python3
"""Where the time of the PyTorch port's Hilbert build goes, on one CUDA card.

    python3 scripts/profile_torch_build.py [--n 100000] [--iters 64]
        [--method giga|frankwolfe|orthopursuit|importance|uniform] [--segment K]

Builds the main-path problem (bench.py's flagship build: logistic N x D=10,
S=500 samples theta ~ 0.1 N(0, I), max_active=1024; int8 select for the
greedy solvers, which the sampling solvers do not use), warms the build up
past the first refresh (65 iterations; OMP 33, so that its active set stays
small) and through one window (which captures the window's CUDA graphs),
then profiles a window of ``--iters`` iterations with torch.profiler and
prints: wall time per iteration, device-busy time per iteration (sum of
kernel times), the idle share, kernel launches (a replayed graph's kernel
nodes) per iteration, the graphs captured and their capture seconds, and
the kernels by total time.  The build replays CUDA graphs by default;
``--segment 1`` runs it in one-iteration segments (``snnls.build``'s
``segment``).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--method", default="giga", choices=bc.snnls.METHODS)
    ap.add_argument("--segment", type=int, default=None)
    args = ap.parse_args()
    from bayesian_coresets_tpu_torch.ops import graphs
    from bayesian_coresets_tpu_torch.utils import config
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_build: needs a CUDA card")
    dev = torch.device("cuda")
    d, S = 10, 500
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), args.n, d)
    proj = bc.BlackBoxProjector(lambda g, n, w, p: 0.1 * torch.randn((n, d), generator=g,
                                                                   device=g.device), S,
                                logistic.log_likelihood,
                                generator=torch.Generator(device=dev).manual_seed(1))
    solver = {cls.method: cls for cls in (bc.snnls.GIGA, bc.snnls.FrankWolfe,
                                          bc.snnls.OrthoPursuit, bc.snnls.ImportanceSampling,
                                          bc.snnls.UniformSampling)}[args.method]
    greedy = args.method in ("giga", "frankwolfe", "orthopursuit")
    c = bc.HilbertCoreset(Z, proj, snnls=solver, max_active=1024,
                          select_dtype=torch.int8 if greedy else None)
    sn, it = c.snnls, args.iters

    def window(state):
        return bc.snnls.build(sn.consts, state, it, config.TOL, method=args.method,
                              draws=sn._gen, matvec_k=1024, segment=args.segment)

    sn.build(33 if args.method == "orthopursuit" else 65)        # past the first refresh
    s = sn.state
    window(s)                                  # captures the window's graphs
    torch.cuda.synchronize()
    caps, cap_s = graphs.captures, graphs.capture_s
    t0 = time.perf_counter()
    window(s)                                  # clean window: one refresh inside
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(s)                              # profiled window: one refresh inside
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_us = sum(dev_us(e) for e in rows)
    n_kern = sum(e.count for e in rows)
    print(f"card={torch.cuda.get_device_name(0)!r} method={args.method} n={args.n} S={S} "
          f"window={it} iterations segment={args.segment or 'graphs'} graphs_captured={caps} "
          f"capture_s={cap_s:.4f}")
    if not rows:
        print("the profiler recorded no device events; no breakdown")
        return 1
    print(f"wall_ms_per_itr={1e3 * wall / it:.4f} device_busy_ms_per_itr={busy_us / 1e3 / it:.4f} "
          f"idle_share={1 - busy_us / 1e6 / wall:.4f} kernels_per_itr={n_kern / it:.2f}")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:15]:
        print(f"  {dev_us(e) / it:9.2f} us/itr  {e.count / it:6.2f} calls/itr  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
