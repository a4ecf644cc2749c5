#!/usr/bin/env python3
"""The fused GIGA step's kernels (``csrc/giga_step.cu``, ``ops/giga_step.py``)
on one CUDA card, at the benchmark's two shapes.

    python3 scripts/time_giga_step.py [--out FILE]

Shapes: N=100k, S=500, f32 V with an int8 select (``lr100k.giga``'s), and
N=8M int8-resident rows of 512 columns (``lr8m.giga_int8``'s; the rows are
random int8 with random norms).  For each, from a state 70 iterations into
a build (past the first refresh), one JSON line with:

- µs a launch of each kernel inside a CUDA graph (20 launches a graph,
  median of 7 replays): ``directions``, ``update``, ``finish``, beside the
  select's and ``fold_scale``'s (flag clear) at the same shape;
- µs an iteration of a replayed 64-iteration non-refresh segment
  (``snnls._segment``: the directions once, then select, update, fold,
  finish per iteration);
- the plain versions' µs a call on the card (CUDA events, eager ops);
- the kernels' bound: the bytes each moves at 3.35 TB/s (a few KB: they
  are bound by latency);
- the count of graph nodes (libcuda's ``cuGraphGetNodes``) in captured segments of 1 and 2
  non-refresh iterations, and their difference, the nodes of one iteration;
- the host ms to capture and instantiate segments of 64 iterations (with
  and without the refresh) and of 4.

Prints the card's name and power limit first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM_BYTES_PER_S = 3.35e12


def _per_launch_us(torch, fn, per_graph=20, reps=7):
    """Median device µs a call of ``fn`` captured ``per_graph`` times in one
    CUDA graph (run once on the capture stream first)."""
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        fn()
    torch.cuda.current_stream().wait_stream(st)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=st):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b) / per_graph)
    return sorted(times)[reps // 2]


def _eager_us(torch, fn, per_batch=20, batches=7):
    for _ in range(3):
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
        times.append(1e3 * a.elapsed_time(b) / per_batch)
    return sorted(times)[batches // 2]


def _nodes(torch, fn):
    """Graph nodes of ``fn()`` captured (run once on the capture stream
    first), counted by libcuda's ``cuGraphGetNodes``."""
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        fn()
    torch.cuda.current_stream().wait_stream(st)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=st):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None,
                                                       ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes returned {err}")
    return n.value


def _consts(torch, snnls, shape, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    if shape == "n100k_s500_f32":
        A = torch.randn((500, 100_000), generator=gen, device=dev)
        return snnls.make_consts(A, A.sum(dim=1), select_dtype=torch.int8)
    n, S = 8_000_000, 512
    q = torch.randint(-127, 128, (n, S), generator=gen, device=dev, dtype=torch.int8)
    norms = torch.rand(n, generator=gen, device=dev) + 0.5
    b = (q[:4096].float() * (norms[:4096, None] / 127.0)).sum(dim=0)
    return snnls.make_consts_quantized(q, norms, b)


def measure(torch, shape):
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import giga_step, snnls
    dev = torch.device("cuda")
    consts = _consts(torch, snnls, shape, dev)
    K, tol = 1024, 1e-6
    s = snnls.build(consts, snnls.init_state(consts, K), 70, tol)
    carry = snnls._carry(consts, s, int(s.itr) + 10**6)
    c = carry._replace(**{k: t.clone() for k, t in carry.state()._asdict().items()})
    p = snnls._Problem(consts, "giga", tol, K, None, None, None, None, None)
    step = giga_step.Step(consts, c, tol)
    work = step.work

    def select():
        gs.giga_select_into(consts.Vsel, work.dirs, consts.norms, consts.valid, work.f,
                            work.score)

    select()
    S = c.xw.shape[0]
    row_bytes = S * consts.V.element_size()
    clear = torch.zeros((), dtype=torch.bool, device=dev)
    out = {"shape": shape, "n": consts.V.shape[0], "S": S, "K": K,
           "us_in_graph": {
               "directions": _per_launch_us(torch, step.directions),
               "update": _per_launch_us(torch, step.update),
               "finish": _per_launch_us(torch, step.finish),
               "select": _per_launch_us(torch, select),
               "fold_scale_clear": _per_launch_us(torch, lambda: fs.fold_scale(c.w, clear,
                                                                              work.ws2))},
           "plain_us": {
               "directions": _eager_us(torch, lambda: giga_step.directions_ref(consts, c, work)),
               "update": _eager_us(torch, lambda: giga_step.update_ref(consts, c, tol, work)),
               "finish": _eager_us(torch, lambda: giga_step.finish_ref(consts, c, work))},
           # directions: b and xw read, dirs written; update: b, xw read and
           # written, the row, the slots; finish: directions' and one weight
           "bound_us": {
               "directions": 1e6 * 16 * S / HBM_BYTES_PER_S,
               "update": 1e6 * (12 * S + row_bytes + 4 * K) / HBM_BYTES_PER_S,
               "finish": 1e6 * (16 * S + 4) / HBM_BYTES_PER_S}}
    seg = 64
    out["segment_us_per_itr"] = _per_launch_us(
        torch, lambda: snnls._segment(p, c, seg, False), per_graph=1) / seg
    n1, n2 = (_nodes(torch, lambda m=m: snnls._segment(p, c, m, False)) for m in (1, 2))
    out["graph_nodes"] = {"segment_1": n1, "segment_2": n2, "per_iteration": n2 - n1}
    out["capture_host_ms"] = {f"segment_{m}_refresh_{r}": _capture_ms(
        torch, lambda m=m, r=r: snnls._segment(p, c, m, r)) for m, r in ((64, True), (64, False),
                                                                         (4, False))}
    return out


def _capture_ms(torch, fn):
    """Host ms to capture and instantiate ``fn()`` in a CUDA graph on a
    stream it has run on once (as ``ops/graphs.py`` captures)."""
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(g, stream=st):
        fn()
    return 1e3 * (time.perf_counter() - t0)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_giga_step: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    lines = []
    for shape in ("n100k_s500_f32", "n8m_s512_int8_resident"):
        line = measure(torch, shape)
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
