#!/usr/bin/env python3
"""Time the select kernels' wide-row path over a sweep of shapes and builds.

    python3 scripts/sweep_wide_select.py [--other NAME=DIR ...] [--quick | --mid | --score]
                                         [--out FILE]

Builds the package's ``csrc/`` several times with nvcc (one process per
source and build, all at once), each build with other compile-time
constants, and times each build's C entry point on the same inputs, in one
process on one card, with CUDA events (median of batches of direct
launches; every matrix here is far larger than L2, so a batch is as cold
as a single launch):

- ``R8``: the package as it is (GIGA rows past 4 KB, int8 past 4608
  bytes, on the wide-row kernel: groups of 8 rows walked in 4 KB pieces,
  up to 4 ring stages);
- ``ring48``: GIGA rows up to 48 KB on the ring kernel, as before the
  mid-width rows moved (``BCT_GIGA_RING_MAX_ROW``): beside ``R8`` on the
  4-48 KB shapes it shows the crossover of the two designs;
- ``R4``, ``R16``: 4 or 16 rows per group (``BCT_WIDE_GROUP_ROWS``);
- ``S3``: at most 3 ring stages past 48 KB (``BCT_WIDE_MAX_STAGES``);
- ``allwide``: every row through the wide-row kernel (ring limits 0), to
  compare the two kernels on rows the ring kernel takes;
- ``NAME``: with ``--other NAME=DIR``, the sources in ``DIR`` (another
  version's ``csrc/``, e.g. unpacked from ``git archive``).

With ``--score`` it builds only the package (and ``--other`` sources) and
times ``giga_score_launch`` (and the empty kernel launched by the same host
path, where a build has it) on (n, 2) dots at n=100000 int32, 50000 f32 and
1000000 int32, each as a batch of direct launches and as a CUDA graph of 20
launches (device time without the host's calls).

Shapes: the wide rows (past 48 KB), f32 S=16384 over n, and the mid-width
rows, 4 KB to 48 KB at int8, bf16 and f32 (``MID``: about 200 MB each, and
``linear_regression --alg GIGA-OPT-EXACT``'s f32 (10000, 10301)), some of
them also through the dots-only mode (``dots-<dtype>``).  Every build's
index (the dots: int32 equal, f32 within 1e-5 of the largest) is checked
against the plain version's on every shape.  Prints one line per (shape,
build) and the ptxas lines of the wide-row kernels, and writes everything
to ``--out`` (default ``results/sweep_wide_select.json``).
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
VARIANTS = {"R8": [], "ring48": ["-DBCT_GIGA_RING_MAX_ROW=49152"],
            "R4": ["-DBCT_WIDE_GROUP_ROWS=4"], "R16": ["-DBCT_WIDE_GROUP_ROWS=16"],
            "S3": ["-DBCT_WIDE_MAX_STAGES=3"],
            "allwide": ["-DBCT_GIGA_RING_MAX_ROW=0", "-DBCT_PACKED_RING_MAX_ROW=0"]}
SCORE_SHAPES = [("int32", 100_000), ("float32", 50_000), ("int32", 1_000_000)]
ELEM = {"int8": 1, "bfloat16": 2, "float32": 4}
# the mid-width rows: 4 KB (the ring kernel's last f32 and bf16 width) to
# 48 KB, with the int8 crossover (4608 and 4864 bytes), each dtype at about
# 200 MB (far past L2), and the linear_regression driver's f32 select
# (N=10000, d + p^2 = 301 + 100^2 columns, padded to 41216 bytes)
MID_ROW_BYTES = [4096, 4112, 4608, 4864, 5120, 6144, 8192, 8208, 10240, 12288, 16384, 24576,
                 32768, 41216, 49152]
MID = ([(k, 200_000_000 // rb, rb // ELEM[k]) for rb in MID_ROW_BYTES for k in ELEM]
       + [("float32", 10_000, 10_301)])
# the dots-only mode at mid-width rows, with the proj-sharded S=16384 build's
# local block (50000, 8192)
DOTS = [("dots-float32", 50_000, 8192), ("dots-int8", 48_828, 4096),
        ("dots-int8", 12_207, 16384), ("dots-float32", 32_435, 1542)]
# (kind, n, S): the n=4096 wide shapes, f32 S=16384 over n, f32 rows on and
# off 128-byte multiples, and rows the ring kernel takes (for ``allwide``)
SHAPES = ([("float32", 4096, 12289), ("float32", 4096, 12320), ("float32", 4096, 16384),
           ("float32", 4096, 16388), ("bfloat16", 4096, 24584), ("int8", 4096, 49168),
           ("int8", 4096, 49280), ("packed", 4096, 65568)]
          + [("float32", n, 16384) for n in (132 * 8, 16384, 100_000)]
          + [("float32", 2048, 32772), ("float32", 512, 262144)]
          + [("float32", 16384, 4096), ("float32", 8192, 8192), ("float32", 4096, 12288),
             ("int8", 16384, 32768), ("packed", 8192, 32768)]
          + MID + DOTS)
# the five n=4096 wide shapes, and the ring kernel's int8 rows at phase 6's N
# and at N=1M (chip_smoke.py phase 3), for a build beside another version
QUICK = ([s for s in SHAPES if s[1] == 4096 and s[2] in (12289, 16384, 24584, 49168, 65568)]
         + [("int8", 100_000, 500), ("int8", 1_000_000, 500)])


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
        elif ("wide" in entry or "score" in entry) and ("Used" in ln or "spill" in ln):
            print(f"  ptxas R8 {entry}: {ln.strip()}", flush=True)
    return {name: lib for name, (lib, _) in links.items()}


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.giga_select_launch.argtypes = [ptr, i32, i64, i64, ptr, i32] + [ptr] * 6
    lib.packed_select_launch.argtypes = [ptr, i64, i64, ptr, i32] + [ptr] * 6
    lib.giga_dots_launch.argtypes = [ptr, i32, i64, i64, ptr, i32, ptr, ptr]
    lib.giga_select_launch.restype = lib.packed_select_launch.restype = ctypes.c_int
    lib.giga_dots_launch.restype = ctypes.c_int
    for name in ("giga_score_launch", "giga_empty_launch"):
        if hasattr(lib, name):          # an older build may lack the empty kernel
            getattr(lib, name).argtypes = [ptr, i32, i64] + [ptr] * 6
            getattr(lib, name).restype = ctypes.c_int
    return lib


def run_score(torch, libs, kind, n):
    """The score kernel of every build on one (n, 2) dots input: its index
    against the plain version's, a batch of direct launches and a CUDA
    graph of them (``chip_smoke._graph_ms``), and the empty kernel alike."""
    from chip_smoke import _graph_ms
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    gen = torch.Generator(device="cuda").manual_seed(n)
    norms = torch.rand(n, generator=gen, device="cuda") * 1.5 + 0.5
    if kind == "int32":
        dots = torch.randint(-16129, 16130, (n, 2), generator=gen, device="cuda",
                             dtype=torch.int32)
    else:
        dots = (torch.rand((n, 2), generator=gen, device="cuda") * 2 - 1) * norms[:, None]
    valid = torch.rand(n, generator=gen, device="cuda") > 0.1
    want = int(gs.giga_score_select_ref(dots, norms, valid)[0])
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    idx = torch.empty(1, dtype=torch.int32, device="cuda")
    score = torch.empty(1, dtype=torch.float32, device="cuda")
    ws = torch.zeros(2, dtype=torch.int64, device="cuda")
    head = (ptr(dots), int(kind == "int32"), n, ptr(norms), ptr(valid), ptr(ws), ptr(idx),
            ptr(score))
    rows = []
    for name, lib in libs.items():
        for fn_name in ("giga_score_launch", "giga_empty_launch"):
            if not hasattr(lib, fn_name):
                continue
            fn = getattr(lib, fn_name)

            def make(st, fn=fn):
                def launch():
                    err = fn(*head, ctypes.c_void_p(st))
                    if err:
                        raise RuntimeError(f"{name} {fn_name}: CUDA error {err}")
                return launch
            direct = make(torch.cuda.current_stream().cuda_stream)
            direct()
            torch.cuda.synchronize()
            ok = fn_name == "giga_empty_launch" or int(idx[0]) == want
            batch = median_ms(torch, direct)
            graph = _graph_ms(torch, make)
            rows.append(dict(kind=f"score-{kind}", n=n, build=name, fn=fn_name,
                             batch_us=1e3 * batch, graph_us=1e3 * graph, idx_ok=ok))
            print(f"[sweep_score] kind={kind} n={n} build={name} fn={fn_name} "
                  f"batch_us={1e3 * batch:.2f} graph_us={1e3 * graph:.2f} "
                  f"idx={'ok' if ok else f'WRONG({int(idx[0])}!={want})'}", flush=True)
    return rows


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
    dt = getattr(torch, kind.removeprefix("dots-"))
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
    dots = kind.startswith("dots-")
    out = torch.empty((n, 2), dtype=torch.int32 if M.dtype == torch.int8 else torch.float32,
                      device="cuda")
    if kind == "packed":
        want = int(ps.packed_select_ref(*args)[0])
        nbytes = M.numel() + 8 * n + 8 * S + 8
    elif dots:
        want = gs.giga_dots_ref(M, args[1])
        nbytes = M.numel() * M.element_size() + 8 * S + 8 * n
    else:
        want = int(gs.giga_select_ref(*args)[0])
        nbytes = M.numel() * M.element_size() + n + 8 * S + 8 + (4 * n if kind != "int8" else 0)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    rows = []
    for name, lib in libs.items():
        if kind == "packed":
            call = (lib.packed_select_launch, ptr(M), n, row_bytes, ptr(args[1]), S,
                    ptr(args[2]), ptr(args[3]), *tail)
        elif dots:
            call = (lib.giga_dots_launch, ptr(M), gs._DTYPE_CODE[M.dtype], n, row_bytes,
                    ptr(args[1]), S, ptr(out), ctypes.c_void_p(stream))
        else:
            call = (lib.giga_select_launch, ptr(M), gs._DTYPE_CODE[M.dtype], n, row_bytes,
                    ptr(args[1]), S, ptr(args[2]), ptr(args[3]), *tail)

        def launch(call=call):
            err = call[0](*call[1:])
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        launch()
        torch.cuda.synchronize()
        if dots:       # int32 dots exact; f32 sums in another order than the plain matmul's
            tol = 0.0 if M.dtype == torch.int8 else 1e-5 * float(want.abs().max())
            ok = float((out.double() - want.double()).abs().max()) <= tol
            got = "ok" if ok else "WRONG(dots)"
        else:
            ok = int(idx[0]) == want
            got = "ok" if ok else f"WRONG({int(idx[0])}!={want})"
        ms = median_ms(torch, launch)
        rows.append(dict(kind=kind, n=n, S=S, row_bytes=row_bytes, build=name, us=1e3 * ms,
                         bound_us=1e3 * bound_ms, share=bound_ms / ms, idx_ok=ok))
        print(f"[sweep] kind={kind} n={n} S={S} row_bytes={row_bytes} build={name} "
              f"us={1e3 * ms:.2f} bound_us={1e3 * bound_ms:.2f} share={bound_ms / ms:.3f} "
              f"idx={got}", flush=True)
    return rows


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="another version's csrc/ to time beside, as build NAME")
    ap.add_argument("--quick", action="store_true",
                    help="the five n=4096 wide shapes and two ring-kernel shapes only")
    ap.add_argument("--mid", action="store_true",
                    help="the mid-width (4-48 KB) shapes and the dots-only mode only")
    ap.add_argument("--score", action="store_true",
                    help="the score kernel and its empty-kernel floor only")
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "sweep_wide_select.json",
                    help="where the JSON of every row goes")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_wide_select: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    csrc = ROOT / "bayesian_coresets_tpu_torch" / "csrc"
    variants = {k: (csrc, v) for k, v in ({"R8": []} if opts.score else VARIANTS).items()}
    for spec in opts.other:
        name, _, path = spec.partition("=")
        variants[name] = (Path(path).resolve(), [])
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = {k: load(p) for k, p in build(variants, Path(tmp)).items()}
        print(f"[sweep_build] seconds={time.perf_counter() - t0:.1f}", flush=True)
        rows = []
        for kind, n in (SCORE_SHAPES if opts.score else []):
            rows += run_score(torch, libs, kind, n)
        for kind, n, S in ([] if opts.score else QUICK if opts.quick else
                           MID + DOTS if opts.mid else SHAPES):
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
