#!/usr/bin/env python3
"""What ``torch.distributed`` offers for the sharded paths on one card.

    python3 scripts/probe_torch_backends.py

Each case spawns its ranks with ``parallel.run_local`` and prints one
``[probe]`` line: NCCL with one rank (an all_reduce of a CUDA tensor), NCCL
with two ranks on the same card, and gloo with two ranks on that card (an
all_reduce, and an all_gather, of CUDA tensors).  A case that fails prints
the error's last line; the script exits 0 unless it could not run at all.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _case(op: str) -> str:
    import torch
    import torch.distributed as dist

    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device="cuda")
    if op == "all_reduce":
        dist.all_reduce(x)
        want = float(w * (w + 1) // 2)
        return f"ok sum={float(x[0])} want={want}"
    outs = [torch.empty_like(x) for _ in range(w)]
    dist.all_gather(outs, x)
    return "ok " + ",".join(f"{float(o[0]):g}" for o in outs)


def main() -> int:
    import torch
    import torch.distributed as dist

    from bayesian_coresets_tpu_torch.parallel import run_local

    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_backends: needs a CUDA card")
    print(f"[probe] torch={torch.__version__} cuda={torch.version.cuda} "
          f"cards={torch.cuda.device_count()} nccl={dist.is_nccl_available()} "
          f"gloo={dist.is_gloo_available()}", flush=True)
    cases = [("nccl", 1, "all_reduce"), ("nccl", 2, "all_reduce"),
             ("gloo", 2, "all_reduce"), ("gloo", 2, "all_gather")]
    with tempfile.TemporaryDirectory() as d:
        for i, (backend, world, op) in enumerate(cases):
            try:
                res = run_local(_case, world, backend, os.path.join(d, f"init{i}"), args=(op,),
                                timeout=120)
                what = res[0]
            except RuntimeError as e:
                lines = [ln for ln in str(e).strip().splitlines() if ln.strip()]
                what = "failed: " + (lines[-1] if lines else "?")
            print(f"[probe] backend={backend} world={world} one_card=True op={op} {what}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
