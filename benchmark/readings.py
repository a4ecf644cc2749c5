"""The readings that a cell's limits are set from, at the cell's own sizes.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--control]
        [--plants name,...|all] [--out FILE]

For each seed: the data of a run with that seed, one warm-up job, and as many
jobs as a run's check holds (``check_builds`` of the cell's file); then the
numbers that the check compares, for the program's answers (``sound``), for
the reference in the program's place computed in the precision below the
configuration's (``control``), and for the program with each planted fault
(``plant:<name>``, one of the ``PLANTS`` that the cell's job declares;
``all`` for every one).  One JSON line per reading on standard output, and
all of them in ``--out``.  The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, dev, control: bool, plants) -> list[dict]:
    from benchmark import harness

    kind = harness.job_module(cell.traffic)
    job = kind.Job(cell.config, cell.traffic, cell.check, seed, dev)
    job.warm()
    k = cell.check["check_builds"]
    t0 = time.perf_counter()
    for i in range(k):
        job.run(i)
    harness.sync(dev)
    job_s = (time.perf_counter() - t0) / k
    t0 = time.perf_counter()
    numbers, seen = job.check(range(k))
    out = [{"seed": seed, "kind": "sound", "jobs": k, "job_s": job_s,
            "check_s": time.perf_counter() - t0, **numbers, "seen": seen}]
    if control:
        numbers, seen = job.check(range(k), control=True)
        out.append({"seed": seed, "kind": "control", **numbers, "seen": seen})
    for name in plants:
        with kind.PLANTS[name]():
            for i in range(k):
                job.run(i)
        numbers, seen = job.check(range(k))
        out.append({"seed": seed, "kind": f"plant:{name}", **numbers, "seen": seen})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--plants", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    cell = harness.resolve(harness.load_spec(), args.workload)
    dev = torch.device("cuda", 0)
    plants = [x for x in args.plants.split(",") if x]
    if plants == ["all"]:
        plants = sorted(harness.job_module(cell.traffic).PLANTS)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in readings(cell, seed, dev, args.control, plants):
            r["workload"] = args.workload
            print(json.dumps(r), flush=True)
            lines.append(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    found = harness.forbidden_modules()
    if found:
        print(f"readings.py: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
