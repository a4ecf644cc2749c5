#!/usr/bin/env python3
"""Where the time of the PyTorch port's weighted NUTS goes, on one CUDA card.

    python3 scripts/profile_torch_nuts.py [--chains 1024] [--transitions 20]

Builds the main-path coreset (bench.py's flagship build: logistic N=100k,
D=10, S=500 samples theta ~ 0.1 N(0, I), int8 select, M=500), adapts
weighted NUTS on it (``mcmc.weighted.run``, 150 warmup draws), then takes
the adapted step sizes and metrics into the preconditioned space that
``run`` samples and times a window of ``--transitions`` NUTS transitions
from the last draws: unprofiled, then under torch.profiler.  It prints wall
ms per transition, device-busy ms (sum of kernel times), the idle share,
kernel launches, host reads and leaf steps per transition, and the kernels
by total time.
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
    from bayesian_coresets_tpu_torch import mcmc
    from bayesian_coresets_tpu_torch.mcmc import nuts, weighted
    from bayesian_coresets_tpu_torch.models import logistic

    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--transitions", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_nuts: needs a CUDA card")
    dev = torch.device("cuda")
    n, d, S, M = 100_000, 10, 500, 500
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), n, d)
    proj = bc.BlackBoxProjector(
        lambda g, k, w, p: 0.1 * torch.randn((k, d), generator=g, device=g.device), S,
        logistic.log_likelihood, generator=torch.Generator(device=dev).manual_seed(1))
    c = bc.HilbertCoreset(Z, proj, select_dtype=torch.int8, max_active=1024)
    c.build(M)
    wts, pts, _ = c.get()
    zc, wc = torch.as_tensor(pts, device=dev), torch.as_tensor(wts, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    _, _, res = weighted.run(logistic, zc, wc, 10, gen, num_chains=args.chains,
                             target_accept=0.8, num_warmup=150)

    # the preconditioned density run() samples, and its last draws in u space
    lap = weighted.fit_laplace(logistic, zc, wc, d)
    rel = weighted.weighted_logdensity(logistic, zc, wc, ref=lap.mu)
    vg = mcmc.value_and_grad(lambda u: rel(lap.mu + u @ lap.USig.T))
    u = torch.linalg.solve_triangular(lap.USig, (res.samples[:, -1] - lap.mu).T, upper=True).T
    state = mcmc.IntegratorState(u, torch.zeros_like(u), *vg(u))
    step, inv_mass = res.step_size, res.inv_mass

    def window():
        nonlocal state
        for _ in range(args.transitions):
            state, _ = nuts.nuts_kernel(vg, gen, state, step, inv_mass, max_depth=15)
        torch.cuda.synchronize()

    window()                                   # warm
    T = args.transitions
    nuts.host_reads = nuts.leaf_steps = 0
    t0 = time.perf_counter()
    window()
    wall = time.perf_counter() - t0
    reads, leaves = nuts.host_reads / T, nuts.leaf_steps / T
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_us = sum(dev_us(e) for e in rows)
    n_kern = sum(e.count for e in rows)
    print(f"card={torch.cuda.get_device_name(0)!r} chains={args.chains} atoms={zc.shape[0]} "
          f"window={T} transitions")
    if not rows:
        print("the profiler recorded no device events; no breakdown")
        return 1
    print(f"wall_ms_per_transition={1e3 * wall / T:.4f} "
          f"device_busy_ms_per_transition={busy_us / 1e3 / T:.4f} "
          f"idle_share={1 - busy_us / 1e6 / wall:.4f} kernels_per_transition={n_kern / T:.2f} "
          f"host_reads_per_transition={reads:.2f} leaf_steps_per_transition={leaves:.2f} "
          f"wall_ms_per_leaf={1e3 * wall / T / leaves:.4f} kernels_per_leaf={n_kern / T / leaves:.2f}")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:15]:
        print(f"  {dev_us(e) / T:9.2f} us/transition  {e.count / T:7.2f} calls/transition  "
              f"{e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
