#!/usr/bin/env python3
"""Where the time of the PyTorch port's weighted NUTS goes, on one CUDA card:
replayed CUDA graphs beside the direct transitions, in one process.

    python3 scripts/profile_torch_nuts.py [--model logistic|poisson] [--chains N]
        [--transitions 20] [--segment 1,2,4,8] [--leaves-only] [--out FILE]

Builds a coreset as ``chip_smoke.py`` does (logistic: phase 6's flagship
build, N=100k, D=10, S=500 samples theta ~ 0.1 N(0, I), int8 select, M=500,
1024 chains by default; poisson: phase 15's, N=100k, S=500, M=200, 256
chains), adapts weighted NUTS on it (``mcmc.weighted.run``, 150 warm-up
draws) and takes the adapted step sizes and metrics into the
preconditioned space that ``run`` samples.  Then, from the last draws and
a generator seeded alike, each path runs three windows of
``--transitions`` transitions: the direct transitions (``graphs=False``),
then the replayed ones for each ``--segment`` K (leaves between two host
reads), and with ``--leaves-only`` the first K with only the leaves
replayed (a transition's start, a doubling's start and its merge run
directly on the same buffers).  The first window of a replayed path makes
its graphs; the second is timed; the third repeats it (the same start,
the generator set back) under torch.profiler.  One line per path: wall
ms per transition, device-busy ms (sum of kernel times) and idle share,
kernels (graph nodes) per transition and per leaf, host reads and leaves
per transition, graphs captured and their capture and instantiate
seconds, peak allocation, and whether the states after the windows equal
the direct path's bit for bit.  ``--out`` writes the lines as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def coreset(torch, model: str, dev):
    """(model module, points, weights, d) of the coreset NUTS samples."""
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic, poisson

    n, S = 100_000, 500
    if model == "logistic":
        d, M, mod = 10, 500, logistic
        Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), n, d)
        sampler = lambda g, k, w, p: 0.1 * torch.randn((k, d), generator=g,  # noqa: E731
                                                       device=g.device)
    else:
        d, M, mod = 2, 200, poisson
        Z = poisson.gen_synthetic(torch.Generator(device=dev).manual_seed(0), n)
        sampler = lambda g, k, w, p: (torch.tensor([1.0, 0.0], device=g.device)  # noqa: E731
                                      + 0.05 * torch.randn((k, d), generator=g, device=g.device))
    proj = bc.BlackBoxProjector(sampler, S, mod.log_likelihood,
                                generator=torch.Generator(device=dev).manual_seed(1))
    c = bc.HilbertCoreset(Z, proj, select_dtype=torch.int8, max_active=1024)
    c.build(M)
    wts, pts, _ = c.get()
    return mod, torch.as_tensor(pts, device=dev), torch.as_tensor(wts, device=dev), d


def adapted(torch, mod, zc, wc, d, chains):
    """``weighted.run``'s result after 150 warm-up transitions and 10 draws."""
    from bayesian_coresets_tpu_torch.mcmc import weighted

    gen = torch.Generator(device=zc.device).manual_seed(5)
    return weighted.run(mod, zc, wc, 10, gen, d=d, num_chains=chains, target_accept=0.8,
                        num_warmup=150)[2]


def u_space(torch, mod, zc, wc, d, res):
    """The u-space value-and-grad that ``weighted.run`` samples, a state at
    the last draws of its result ``res``, and the adapted step sizes and
    metric."""
    from bayesian_coresets_tpu_torch import mcmc
    from bayesian_coresets_tpu_torch.mcmc import weighted

    lap = weighted.fit_laplace(mod, zc, wc, d)
    rel = weighted.weighted_logdensity(mod, zc, wc, ref=lap.mu)
    vg = mcmc.value_and_grad(lambda u: rel(lap.mu + u @ lap.USig.T))
    u = torch.linalg.solve_triangular(lap.USig, (res.samples[:, -1] - lap.mu).T, upper=True).T
    return vg, mcmc.IntegratorState(u, torch.zeros_like(u), *vg(u)), res.step_size, res.inv_mass


def leaves_only(mcmc):
    """Transitions that replay only their segments of leaves."""
    from bayesian_coresets_tpu_torch.mcmc import nuts

    class LeavesOnly(mcmc.Transitions):
        def _replay(self, key, fn, st):
            if key[0] == "leaves":
                return super()._replay(key, fn, st)
            nuts._put(st, fn(st))
            return st

    return LeavesOnly


def window_stats(torch, vg, state, step, inv_mass, T, graphs=False, segment=None,
                 max_depth=15, seed=9, only_leaves=False):
    """Three windows of T transitions from ``state`` on one path (see the
    module docstring); returns (stats, the state after them)."""
    from torch.profiler import ProfilerActivity, profile

    from bayesian_coresets_tpu_torch import mcmc
    from bayesian_coresets_tpu_torch.mcmc import nuts
    from bayesian_coresets_tpu_torch.ops import graphs as cg

    kind = leaves_only(mcmc) if only_leaves else mcmc.Transitions
    gen = torch.Generator(device=state.z.device).manual_seed(seed)
    kern = kind(vg, gen, max_depth, segment, graphs)
    chol = mcmc.integrators.mass_chol(inv_mass)

    def window(st):
        for _ in range(T):
            st, _ = kern(st, step, inv_mass, chol)
        torch.cuda.synchronize()
        return st

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0, cs0, is0 = cg.captures, cg.capture_s, cg.instantiate_s
    t0 = time.perf_counter()
    st = window(state)
    first_s = time.perf_counter() - t0
    caps, cap_s, inst_s = cg.captures - c0, cg.capture_s - cs0, cg.instantiate_s - is0
    # the timed and the profiled window run the same transitions: the same
    # start and the generator set back to the same place
    start, gen_state = st, gen.get_state()
    reads0, leaves0 = nuts.host_reads, nuts.leaf_steps
    t0 = time.perf_counter()
    st = window(start)
    wall = time.perf_counter() - t0
    reads, leaves = (nuts.host_reads - reads0) / T, (nuts.leaf_steps - leaves0) / T
    gen.set_state(gen_state)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = window(start)
    if not same_state(torch, again, st):
        raise AssertionError("the profiled window did not repeat the timed one")
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    kernels = sum(e.count for e in rows)
    path = f"graphs_K{kern.segment}" + ("_leaves_only" if only_leaves else "")
    stats = {"path": path if kern.graphs else "direct",
             "wall_ms_per_transition": 1e3 * wall / T,
             "device_busy_ms_per_transition": busy_us / 1e3 / T if rows else None,
             "idle_share": 1 - busy_us / 1e6 / wall if rows else None,
             "kernels_per_transition": kernels / T, "kernels_per_leaf": kernels / T / leaves,
             "host_reads_per_transition": reads, "leaves_per_transition": leaves,
             "graphs_captured": caps, "capture_s": cap_s, "instantiate_s": inst_s,
             "first_window_s": first_s,
             "peak_GB": torch.cuda.max_memory_allocated() / 1e9}
    top = sorted(rows, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    stats["top_kernels"] = [(e.key[:80], getattr(e, "self_device_time_total", 0.0) / T,
                             e.count / T) for e in top]
    return stats, st


def same_state(torch, a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("logistic", "poisson"), default="logistic")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--transitions", type=int, default=20)
    ap.add_argument("--segment", default="1,2,4,8",
                    help="comma-separated leaves per replayed graph")
    ap.add_argument("--leaves-only", action="store_true",
                    help="also replay only the leaves, at the first segment length")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_nuts: needs a CUDA card")
    dev = torch.device("cuda")
    chains = args.chains or (1024 if args.model == "logistic" else 256)
    mod, zc, wc, d = coreset(torch, args.model, dev)
    vg, state, step, inv_mass = u_space(torch, mod, zc, wc, d, adapted(torch, mod, zc, wc, d,
                                                                        chains))
    card = torch.cuda.get_device_name(0)
    print(f"card={card!r} model={args.model} chains={chains} atoms={zc.shape[0]} "
          f"window={args.transitions} transitions", flush=True)
    lines = []
    ref, ref_state = window_stats(torch, vg, state, step, inv_mass, args.transitions)
    ref["same_as_direct"] = True
    lines.append(ref)
    Ks = [int(k) for k in args.segment.split(",")]
    for K, only in [(K, False) for K in Ks] + ([(Ks[0], True)] if args.leaves_only else []):
        s, st = window_stats(torch, vg, state, step, inv_mass, args.transitions,
                             graphs=True, segment=K, only_leaves=only)
        s["same_as_direct"] = same_state(torch, st, ref_state)
        lines.append(s)
    for s in lines:
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in s.items() if k != "top_kernels"), flush=True)
        for key, us, n in s["top_kernels"]:
            print(f"    {us:9.1f} us/transition {n:8.1f} calls/transition  {key}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "model": args.model,
                                              "chains": chains, "lines": lines}, indent=1))
    return 0 if all(s["same_as_direct"] for s in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
