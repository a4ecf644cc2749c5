#!/usr/bin/env python3
"""Where the time of the PyTorch port's SparseVI and BatchPSVI steps goes,
on one CUDA card, directly and as replayed CUDA graphs.

    python3 scripts/profile_torch_svi.py [--steps 100] [--segment 10,25,50,100]
                                         [--arms svi_blackbox,svi_exact,...]

Arms: SparseVI at bench.py's canonical config (bench.py:211-231: gaussian
N=1000, d=200, S=100 posterior-basis samples, 30 atoms in 32 slots),
black-box (``svi_blackbox``) and with the exact Gaussian tangent family
(``svi_exact``); SparseVI with the logistic_poisson driver's warm Laplace
refit (``svi_logistic``: N=100k, D=10, S=500, 30 atoms in 100 slots, the
driver's full data); BatchPSVI at scripts/bench_svi_tpu.py:138-157's
config (``bpsvi``: N=100k, d=20, S=200, sz=100, 20000-row subsamples) and
with the warm Laplace refit (``bpsvi_logistic``: N=100k, D=10, S=500,
sz=100, full data).

Each arm runs ``--steps`` Adam steps per call (one ``_optimize`` or
``bpsvi_build``), directly (``graphs=False``) and replayed with each
segment length of ``--segment``: two calls first (for the graphs, the
warm-up and the capture), then a timed one and a profiled one
(torch.profiler).  Every call reseeds one generator per path, so each
replayed result is held to the direct one bit for bit.  Per path it prints
wall and device-busy µs per step, the idle share, kernels (graph nodes)
per step, graphs captured and their capture and instantiate seconds, and
for the direct path the kernels by total time.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ARMS = ("svi_blackbox", "svi_exact", "svi_logistic", "bpsvi", "bpsvi_logistic")


def _profile(torch, fn, steps):
    """(device-busy µs per step, kernels per step, rows) of one call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    return busy / steps, sum(e.count for e in rows) / steps, rows


def _same(torch, a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and bool(torch.equal(a, b))
    return all(_same(torch, x, y) for x, y in zip(a, b))


def _arm(torch, label, call, steps, segments, smi):
    """``call(graphs, segment, gen)`` runs ``steps`` Adam steps."""
    from bayesian_coresets_tpu_torch.ops import graphs

    dev = torch.device("cuda")
    ref = None
    for graphs_arg, K in [(False, 1)] + [(None, k) for k in segments]:
        gen = torch.Generator(device=dev)
        caps0, cap0, inst0 = graphs.captures, graphs.capture_s, graphs.instantiate_s

        def fn():
            gen.manual_seed(3)
            return call(graphs_arg, K, gen)

        fn()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy, kernels, rows = _profile(torch, fn, steps)
        out = tuple(t.clone() for t in out)
        same = "reference" if ref is None else ("yes" if _same(torch, out, ref) else "NO")
        ref = out if ref is None else ref
        path = "direct" if graphs_arg is False else f"graphs_K{K}"
        busy_s = f"{busy:.2f}" if rows else "not_measured"
        idle = f"{1.0 - busy * 1e-6 * steps / wall:.4f}" if rows else "not_measured"
        print(f"[{label}] path={path} steps={steps} wall_us_per_step={1e6 * wall / steps:.2f} "
              f"device_busy_us_per_step={busy_s} idle_share={idle} "
              f"kernels_per_step={kernels:.2f} graphs_captured={graphs.captures - caps0} "
              f"capture_s={graphs.capture_s - cap0:.4f} "
              f"instantiate_s={graphs.instantiate_s - inst0:.4f} same_as_direct={same} "
              f"card={smi!r}", flush=True)
        if graphs_arg is False:
            dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
            for e in sorted(rows, key=lambda e: -dev_us(e))[:8]:
                print(f"  {dev_us(e) / steps:9.2f} us/step  {e.count / steps:6.2f} calls/step  "
                      f"{e.key[:100]}")
        if same == "NO":
            raise SystemExit(f"{label}: {path} differs from the direct steps")


def main() -> int:
    import subprocess

    import torch

    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.coresets import bpsvi, sparsevi
    from bayesian_coresets_tpu_torch.experiments.logistic_poisson import laplace_refits
    from bayesian_coresets_tpu_torch.models import gaussian, logistic

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--segment", default="10,25,50,100")
    ap.add_argument("--arms", default=",".join(ARMS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_svi: needs a CUDA card")
    segments = [int(k) for k in args.segment.split(",") if k]
    dev = torch.device("cuda")
    sched = lambda i: 1.0 / (1.0 + i)   # noqa: E731
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip()
    print(f"card={smi!r} steps={args.steps} segments={segments}", flush=True)

    def gauss_family(d, S, grad=False):
        mu0, eye = torch.zeros(d, device=dev), torch.eye(d, device=dev)
        basis = gaussian.posterior_basis(mu0, eye, eye)
        if S is None:
            return bc.gaussian_tangent_family(mu0, eye, eye, eye, basis=basis)

        def sampler(g, n, w, p):
            return gaussian.sample_weighted_post_basis(g, basis, p, w, n)

        gll = (lambda p, th: gaussian.grad_x_log_likelihood(p, th, eye)) if grad else None
        return bc.coresets.blackbox_family(
            sampler, S, lambda p, th: gaussian.log_likelihood(p, th, eye, 0.0), gll)

    def logistic_family(d, S):
        sampler, warm, init = laplace_refits(logistic, d, dev)
        return bc.coresets.blackbox_family(sampler, S, logistic.log_likelihood,
                                           logistic.grad_z_log_likelihood,
                                           warm_sampler=warm, init_carry=init)

    def svi_call(x, fam, cap, atoms):
        w, idcs, size = sparsevi.svi_build(
            x, torch.zeros(cap, device=dev), torch.full((cap,), -1, dtype=torch.int64, device=dev),
            0, torch.Generator(device=dev).manual_seed(2), atoms, family=fam, n_sub_sel=None,
            n_sub_opt=None, opt_itrs=5, step_sched=sched, graphs=False)
        pts = sparsevi._gather_pts(x, idcs)
        carry = sparsevi._init_carry(x, fam, w, pts, size)
        return lambda graphs, K, gen: sparsevi._optimize(
            x, fam, gen, w, pts, size, None, args.steps, sched, carry, graphs=graphs, segment=K)

    def bpsvi_call(x, fam, sz, n_sub):
        init = bpsvi.uniform_init_idcs(x.shape[0], sz, torch.Generator(device=dev).manual_seed(9))
        return lambda graphs, K, gen: bpsvi.bpsvi_build(
            x, init, gen, family=fam, n_sub_opt=n_sub, opt_itrs=args.steps, step_sched=sched,
            graphs=graphs, segment=K)

    arms = args.arms.split(",")
    xg = gaussian.gen_synthetic(torch.Generator(device=dev).manual_seed(1), 1000, 200)
    zl = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(1), 100_000, 10)
    makers = {
        "svi_blackbox": lambda: svi_call(xg, gauss_family(200, 100), 32, 30),
        "svi_exact": lambda: svi_call(xg, gauss_family(200, None), 32, 30),
        "svi_logistic": lambda: svi_call(zl, logistic_family(10, 500), 100, 30),
        "bpsvi": lambda: bpsvi_call(
            gaussian.gen_synthetic(torch.Generator(device=dev).manual_seed(1), 100_000, 20),
            gauss_family(20, 200, grad=True), 100, 20_000),
        "bpsvi_logistic": lambda: bpsvi_call(zl, logistic_family(10, 500), 100, None),
    }
    for arm in arms:
        _arm(torch, arm, makers[arm](), args.steps, segments, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
