#!/usr/bin/env python3
"""Probe: does the packed-int4 stream beat the int8 stream on a CUDA card?

    python3 scripts/probe_int4_torch.py [--n 1048576] [--S 512] [--iters 16] [--reps 5]

The PyTorch port's counterpart of ``scripts/probe_int4_pallas.py``.  It
builds the probe's two selection copies of one (N, S) matrix of unit rows on
the card, from a seeded ``torch.Generator``: the int8 copy V8 (N*S bytes,
512 MiB at the default size) and the packed copy P of two signed 4-bit
values a byte (N*S/2 bytes, 256 MiB).  It then times the GIGA select kernel
over V8 (``ops/giga_select.py``) against the packed-int4 select kernel over
P (``ops/packed_select.py``): each rep launches ``--iters`` selects with
fresh directions through the wrappers, between two CUDA events, after a
warm-up.  It prints the median ms per call and GB/s over each copy, and the
card's name and power limit.  ``chip_smoke.py`` drives :func:`run_probe`
as the packed kernel's path.

The Pallas probe's tile sweep and its subtraction of the relay's
round-trip time are artifacts of the TPU and its network relay; this
script has neither.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run_probe(torch, V8, P, iters: int = 16, reps: int = 5, seed: int = 9):
    """Time the int8 and the packed select through their wrappers on the
    card: ``iters`` selects with fresh directions per rep, between two CUDA
    events, after a warm-up.  Returns {arm: (median ms per call, GB/s over
    its copy, per-rep ms)}."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps

    n, S = V8.shape
    dev = V8.device
    ones = torch.ones(n, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    bias = torch.zeros(n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dirs = [torch.rand((S, 2), generator=gen, device=dev) * 0.08 - 0.04 for _ in range(iters)]
    arms = {"int8": (lambda d: gs.giga_select(V8, d, ones, valid), V8),
            "packed4": (lambda d: ps.packed_select(P, d, ones, bias), P)}
    out = {}
    for name, (fn, buf) in arms.items():
        for d in dirs:                                  # warm-up (and the build)
            fn(d)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for d in dirs:
                fn(d)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / iters)
        ms = sorted(times)[len(times) // 2]
        out[name] = (ms, buf.numel() * buf.element_size() / (ms * 1e-3) / 1e9, times)
    return out


def main() -> int:
    import torch

    from bayesian_coresets_tpu_torch.ops import packed_select as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--S", type=int, default=512)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_int4_torch: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    V8, P = ps.make_probe_buffers(gen, args.n, args.S)
    for name, (ms, gbps, times) in run_probe(torch, V8, P, args.iters, args.reps).items():
        buf = V8 if name == "int8" else P
        print(f"{name:8s} N={args.n} S={args.S}: {ms:.4f} ms/call  {gbps:7.1f} GB/s over "
              f"{buf.numel() * buf.element_size() / 2**20:.0f} MiB  "
              f"(reps: {' '.join(f'{t:.4f}' for t in times)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
