#!/usr/bin/env python3
"""Time the select kernels' wide-row path over a sweep of shapes and builds.

    python3 scripts/sweep_wide_select.py [--other NAME=DIR ...] [--quick] [--out FILE]

Builds the package's ``csrc/`` several times with nvcc (one process per
source and build, all at once), each build with other compile-time
constants, and times each build's C entry point on the same inputs, in one
process on one card, with CUDA events (median of batches of direct
launches; every matrix here is far larger than L2, so a batch is as cold
as a single launch):

- ``R8``: the package as it is (groups of 8 rows, up to 4 ring stages);
- ``R4``, ``R16``: 4 or 16 rows per group (``BCT_WIDE_GROUP_ROWS``);
- ``S3``: at most 3 ring stages (``BCT_WIDE_MAX_STAGES``);
- ``allwide``: every row through the wide-row kernel (ring limits 0), to
  compare the two kernels on rows the ring kernel takes;
- ``NAME``: with ``--other NAME=DIR``, the sources in ``DIR`` (another
  version's ``csrc/``, e.g. unpacked from ``git archive``).

Every build's index is checked against the plain version's on every shape.
Prints one line per (shape, build) and the ptxas lines of the wide-row
kernels, and writes everything to ``--out`` (default
``results/sweep_wide_select.json``).
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA's data sheet)
VARIANTS = {"R8": [], "R4": ["-DBCT_WIDE_GROUP_ROWS=4"], "R16": ["-DBCT_WIDE_GROUP_ROWS=16"],
            "S3": ["-DBCT_WIDE_MAX_STAGES=3"],
            "allwide": ["-DBCT_GIGA_RING_MAX_ROW=0", "-DBCT_PACKED_RING_MAX_ROW=0"]}
# (kind, n, S): the n=4096 wide shapes, f32 S=16384 over n, f32 rows on and
# off 128-byte multiples, and rows the ring kernel takes (for ``allwide``)
SHAPES = ([("float32", 4096, 12289), ("float32", 4096, 12320), ("float32", 4096, 16384),
           ("float32", 4096, 16388), ("bfloat16", 4096, 24584), ("int8", 4096, 49168),
           ("int8", 4096, 49280), ("packed", 4096, 65568)]
          + [("float32", n, 16384) for n in (132 * 8, 16384, 100_000)]
          + [("float32", 2048, 32772), ("float32", 512, 262144)]
          + [("float32", 16384, 4096), ("float32", 8192, 8192), ("float32", 4096, 12288),
             ("int8", 16384, 32768), ("packed", 8192, 32768)])
QUICK = [s for s in SHAPES if s[1] == 4096 and s[2] in (12289, 16384, 24584, 49168, 65568)]


def build(variants: dict[str, tuple[Path, list[str]]], out: Path) -> dict[str, Path]:
    """Compile every variant's sources at once; returns variant -> library."""
    from bayesian_coresets_tpu_torch.ops import _cuda_build as cb
    nvcc = cb._nvcc()
    jobs, links = [], {}
    for name, (csrc, flags) in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        objs = []
        for src in sorted(csrc.glob("*.cu")):
            o = d / f"{src.stem}.o"
            objs.append(o)
            jobs.append((name, [nvcc, *cb.NVCC_FLAGS, *flags, "-c", "-o", str(o), str(src)]))
        links[name] = (d / "lib.so", objs)
    procs = [(name, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)) for name, c in jobs]
    logs: dict[str, str] = {}
    for name, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        logs[name] = logs.get(name, "") + log
    for name, (lib, objs) in links.items():
        subprocess.run([nvcc, *cb.ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
                       check=True)
    entry = ""
    for ln in logs["R8"].splitlines():          # the wide kernels' resources
        if "entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "wide" in entry and ("Used" in ln or "spill" in ln):
            print(f"  ptxas R8 {entry}: {ln.strip()}", flush=True)
    return {name: lib for name, (lib, _) in links.items()}


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.giga_select_launch.argtypes = [ptr, i32, i64, i64, ptr, i32] + [ptr] * 6
    lib.packed_select_launch.argtypes = [ptr, i64, i64, ptr, i32] + [ptr] * 6
    lib.giga_select_launch.restype = lib.packed_select_launch.restype = ctypes.c_int
    return lib


def median_ms(torch, fn, batches=7, per_batch=10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return sorted(times)[len(times) // 2]


def inputs(torch, kind, n, S):
    """Random inputs on the card: the selection copy, (S, 2) unit
    directions, norms, valid; for ``packed``, (P, dirs, nrminv, bias)."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps
    gen = torch.Generator(device="cuda").manual_seed(S + n)
    dirs = torch.randn((S, 2), generator=gen, device="cuda")
    dirs = (dirs / torch.linalg.vector_norm(dirs, dim=0)).contiguous()
    if kind == "packed":
        P = ps.padded(torch.randint(-128, 128, (n, S // 2), generator=gen, device="cuda",
                                    dtype=torch.int8))
        return [P, 0.03 * dirs, torch.rand(n, generator=gen, device="cuda") + 0.5,
                torch.zeros(n, device="cuda")]
    dt = getattr(torch, kind)
    Sp = -(-S // gs.col_multiple(dt)) * gs.col_multiple(dt)
    if dt == torch.int8:
        V = torch.randint(-127, 128, (n, Sp), generator=gen, device="cuda", dtype=torch.int8)
        norms = torch.ones(n, device="cuda")
    else:
        V = torch.randn((n, Sp), generator=gen, device="cuda").to(dt)
        norms = torch.linalg.vector_norm(V.float(), dim=1)
    return [V, dirs, norms, torch.ones(n, dtype=torch.bool, device="cuda")]


def run_shape(torch, libs, kind, n, S):
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps
    args = inputs(torch, kind, n, S)
    M = args[0]
    row_bytes = M.shape[1] * M.element_size()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    ws, stream = gs.workspace(M.device)
    idx = torch.empty(1, dtype=torch.int32, device="cuda")
    score = torch.empty(1, dtype=torch.float32, device="cuda")
    tail = (ptr(ws), ptr(idx), ptr(score), ctypes.c_void_p(stream))
    if kind == "packed":
        want = int(ps.packed_select_ref(*args)[0])
        nbytes = M.numel() + 8 * n + 8 * S + 8
    else:
        want = int(gs.giga_select_ref(*args)[0])
        nbytes = M.numel() * M.element_size() + n + 8 * S + 8 + (4 * n if kind != "int8" else 0)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    rows = []
    for name, lib in libs.items():
        if kind == "packed":
            call = (lib.packed_select_launch, ptr(M), n, row_bytes, ptr(args[1]), S,
                    ptr(args[2]), ptr(args[3]), *tail)
        else:
            call = (lib.giga_select_launch, ptr(M), gs._DTYPE_CODE[M.dtype], n, row_bytes,
                    ptr(args[1]), S, ptr(args[2]), ptr(args[3]), *tail)

        def launch(call=call):
            err = call[0](*call[1:])
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        launch()
        torch.cuda.synchronize()
        got = int(idx[0])
        ms = median_ms(torch, launch)
        rows.append(dict(kind=kind, n=n, S=S, row_bytes=row_bytes, build=name, us=1e3 * ms,
                         bound_us=1e3 * bound_ms, share=bound_ms / ms, idx_ok=got == want))
        print(f"[sweep] kind={kind} n={n} S={S} row_bytes={row_bytes} build={name} "
              f"us={1e3 * ms:.2f} bound_us={1e3 * bound_ms:.2f} share={bound_ms / ms:.3f} "
              f"idx={'ok' if got == want else f'WRONG({got}!={want})'}", flush=True)
    return rows


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another version's csrc/ to time beside, as build NAME")
    ap.add_argument("--quick", action="store_true", help="the five n=4096 shapes only")
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "sweep_wide_select.json",
                    help="where the JSON of every row goes")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_wide_select: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    csrc = ROOT / "bayesian_coresets_tpu_torch" / "csrc"
    variants = {k: (csrc, v) for k, v in VARIANTS.items()}
    for spec in opts.other:
        name, _, path = spec.partition("=")
        variants[name] = (Path(path).resolve(), [])
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = {k: load(p) for k, p in build(variants, Path(tmp)).items()}
        print(f"[sweep_build] seconds={time.perf_counter() - t0:.1f}", flush=True)
        rows = []
        for kind, n, S in (QUICK if opts.quick else SHAPES):
            rows += run_shape(torch, libs, kind, n, S)
            torch.cuda.empty_cache()
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    bad = [r for r in rows if not r["idx_ok"]]
    if bad:
        raise SystemExit(f"sweep_wide_select: {len(bad)} wrong indices: {bad[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
