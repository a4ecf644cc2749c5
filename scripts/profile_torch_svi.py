#!/usr/bin/env python3
"""Where the time of the PyTorch port's SparseVI and BatchPSVI steps goes,
on one CUDA card.

    python3 scripts/profile_torch_svi.py [--steps 20]

Profiles, with torch.profiler, a window of ``--steps`` projected-Adam steps
of each of: SparseVI at bench.py's canonical config (bench.py:211-231:
gaussian N=1000, d=200, S=100 posterior-basis samples, 30 atoms), black-box
and with the exact Gaussian tangent family; and BatchPSVI at
scripts/bench_svi_tpu.py:138-157's config (N=100k, d=20, S=200, sz=100,
20000-row subsamples).  For each it prints wall and device-busy µs per
step, the idle share, kernel launches per step, and the kernels by total
time.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _window(torch, label, fn, steps):
    from torch.profiler import ProfilerActivity, profile

    fn()                                        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        print(f"{label}: the profiler recorded no device events; no breakdown")
        return
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy = sum(dev_us(e) for e in rows)
    print(f"{label}: wall_us_per_step={1e6 * wall / steps:.2f} "
          f"device_busy_us_per_step={busy / steps:.2f} idle_share={1 - busy * 1e-6 / wall:.4f} "
          f"kernels_per_step={sum(e.count for e in rows) / steps:.2f}")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:12]:
        print(f"  {dev_us(e) / steps:9.2f} us/step  {e.count / steps:6.2f} calls/step  "
              f"{e.key[:100]}")


def main() -> int:
    import torch

    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.coresets import bpsvi, sparsevi
    from bayesian_coresets_tpu_torch.models import gaussian

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_svi: needs a CUDA card")
    dev = torch.device("cuda")
    sched = lambda i: 1.0 / (1.0 + i)   # noqa: E731
    print(f"card={torch.cuda.get_device_name(0)!r} window={args.steps} steps")

    def family(d, S, grad=False):
        mu0, eye = torch.zeros(d, device=dev), torch.eye(d, device=dev)
        basis = gaussian.posterior_basis(mu0, eye, eye)
        if S is None:
            return bc.gaussian_tangent_family(mu0, eye, eye, eye, basis=basis)

        def sampler(g, n, w, p):
            return gaussian.sample_weighted_post_basis(g, basis, p, w, n)

        gll = (lambda p, th: gaussian.grad_x_log_likelihood(p, th, eye)) if grad else None
        return bc.coresets.blackbox_family(
            sampler, S, lambda p, th: gaussian.log_likelihood(p, th, eye, 0.0), gll)

    x = gaussian.gen_synthetic(torch.Generator(device=dev).manual_seed(1), 1000, 200)
    for label, S in (("svi_blackbox", 100), ("svi_exact", None)):
        fam = family(200, S)
        w, idcs, size = sparsevi.svi_build(
            x, torch.zeros(32, device=dev), torch.full((32,), -1, dtype=torch.int64, device=dev),
            0, torch.Generator(device=dev).manual_seed(2), 30, family=fam, n_sub_sel=None,
            n_sub_opt=None, opt_itrs=5, step_sched=sched)
        pts = sparsevi._gather_pts(x, idcs)
        carry = sparsevi._init_carry(x, fam, w, pts, size)
        gen = torch.Generator(device=dev).manual_seed(3)
        _window(torch, label, lambda: sparsevi._optimize(
            x, fam, gen, w, pts, size, None, args.steps, sched, carry), args.steps)

    xb = gaussian.gen_synthetic(torch.Generator(device=dev).manual_seed(1), 100_000, 20)
    fam = family(20, 200, grad=True)
    init = bpsvi.uniform_init_idcs(100_000, 100, torch.Generator(device=dev).manual_seed(9))
    gen = torch.Generator(device=dev).manual_seed(3)
    _window(torch, "bpsvi", lambda: bpsvi.bpsvi_build(
        xb, init, gen, family=fam, n_sub_opt=20_000, opt_itrs=args.steps, step_sched=sched),
        args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
