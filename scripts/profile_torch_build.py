#!/usr/bin/env python3
"""Where the time of the PyTorch port's GIGA build goes, on one CUDA card.

    python3 scripts/profile_torch_build.py [--n 100000] [--iters 64]

Builds the main-path problem (logistic N x D=10, Laplace samples S=500,
int8 select, max_active=1024), warms the build up, then profiles a window
of ``--iters`` iterations with torch.profiler and prints: wall time per
iteration, device-busy time per iteration (sum of kernel times), the idle
share, kernel launches per iteration, and the kernels by total time.
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
    from bayesian_coresets_tpu_torch.models.laplace import laplace_approx, sample_laplace

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_build: needs a CUDA card")
    dev = torch.device("cuda")
    d, S = 10, 500
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), args.n, d)
    lap = laplace_approx(Z, torch.ones(args.n, device=dev), torch.zeros(d, device=dev),
                         grad_fn=logistic.grad_th_log_joint,
                         hess_fn=logistic.hess_th_log_joint)
    proj = bc.BlackBoxProjector(lambda g, n, w, p: sample_laplace(g, lap, n), S,
                                logistic.log_likelihood,
                                generator=torch.Generator(device=dev).manual_seed(1))
    c = bc.HilbertCoreset(Z, proj, select_dtype=torch.int8, max_active=1024)
    c.snnls.build(65)                          # warm up past the first refresh
    it = args.iters
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c.snnls.build(it)                          # clean window: one refresh inside
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c.snnls.build(it)                      # profiled window: one refresh inside
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_us = sum(dev_us(e) for e in rows)
    n_kern = sum(e.count for e in rows)
    print(f"card={torch.cuda.get_device_name(0)!r} n={args.n} S={S} window={it} iterations")
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
