"""Run one cell of the benchmark on the CUDA card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, the cell's data, one warm-up job), then
a window of whole jobs back to back for ``--seconds``, then the check of the
window's answers against the plain reference.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics read from spans, counters and a traced stretch of jobs),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit, which also end standard error.

It exits non-zero and prints no result where there is no CUDA card, or fewer
than the cell asks for, and where JAX or the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, for the log."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.resolve(harness.load_spec(), args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result, seen = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(seen), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
