#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line when it finishes; any failure raises and the
script exits non-zero without printing the final result line):

1. device: the card, and its name and power limit from nvidia-smi;
2. build: compile the kernel library from ``bayesian_coresets_tpu_torch/csrc``;
3. kernel against plain: the GIGA select kernel against its plain PyTorch
   version on the card, int8/bf16/f32 at (n=100k, S=500) and int8 at
   (n=1M, S=500), with invalid blocks, ties and an all-invalid input;
   median times from CUDA events;
4. build parity: a GIGA build (int8, N=20k, S=500, M=200) on the card
   through the kernel and on the CPU through the plain version, from the
   same arrays, must select the same atoms;
5. main path at full width: logistic data N=100k, D=10 -> Laplace fit ->
   BlackBoxProjector(S=500) -> HilbertCoreset(int8 select, max_active=1024)
   .build(500), with the kernel's launch count checked against the
   iterations run.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  The port imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SELECT_TOL = 1e-6           # relative score tolerance, kernel against plain
N_MAIN, D_MAIN, S_MAIN, M_MAIN = 100_000, 10, 500, 500


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    from bayesian_coresets_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    _cuda_build.load_library()
    secs = time.perf_counter() - t0
    log = _cuda_build.library_path().with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln]
    say("build", seconds=f"{secs:.3f}", library=_cuda_build.library_path().name)
    for ln in ptxas:
        print("  ptxas:", ln, flush=True)


def _median_ms(torch, fn, batches: int = 7, per_batch: int = 20) -> float:
    """Median over batches of the mean device time per call (CUDA events)."""
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
        times.append(a.elapsed_time(b) / per_batch)
    times.sort()
    return times[len(times) // 2]


def _select_problem(torch, n, S, dtype, seed):
    from bayesian_coresets_tpu_torch.ops import snnls
    gen = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.randn((n, S), generator=gen, device="cuda")
    b = V.sum(dim=0)
    c = snnls.make_consts(V.T, b, select_dtype=dtype)
    xw = V[:50].sum(dim=0)
    xwn = xw / torch.linalg.vector_norm(xw)
    bn = b / torch.linalg.vector_norm(b)
    cd = bn - (bn @ xwn) * xwn
    dirs = torch.stack([cd / torch.linalg.vector_norm(cd), xwn], dim=1).contiguous()
    return c, dirs


def phase_select(torch):
    from bayesian_coresets_tpu_torch.ops import _cuda_build
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    lib = _cuda_build.load_library()
    codes = gs._DTYPE_CODE
    max_err, timing = 0.0, {}
    for dtype, n in [(torch.int8, N_MAIN), (torch.bfloat16, N_MAIN),
                     (torch.float32, N_MAIN), (torch.int8, 1_000_000)]:
        c, dirs = _select_problem(torch, n, S_MAIN, dtype, seed=n + codes[dtype])
        Vsel, norms, valid = c.Vsel, c.norms, c.valid

        def check(Vs, nr, ok, label, expect_idx=None):
            nonlocal max_err
            ki, ks = gs.giga_select(Vs, dirs, nr, ok)
            pi, ps = gs.giga_select_ref(Vs, dirs, nr, ok)
            ki, ks, pi, ps = int(ki), float(ks), int(pi), float(ps)
            if ki != pi or (expect_idx is not None and ki != expect_idx):
                raise AssertionError(f"select {dtype} n={n} {label}: kernel index {ki}, "
                                     f"plain {pi}, expected {expect_idx}")
            if ps == float("-inf"):
                if ks != ps:
                    raise AssertionError(f"select {label}: kernel score {ks}, plain -inf")
                return pi
            err = abs(ks - ps)
            if err > SELECT_TOL * abs(ps):
                raise AssertionError(f"select {dtype} n={n} {label}: score {ks} vs {ps}")
            max_err = max(max_err, err)
            return pi

        f = check(Vsel, norms, valid, "random")
        # the winner's 1024-row block invalid: the kernel must skip it
        ok2 = valid.clone()
        ok2[f // 1024 * 1024: f // 1024 * 1024 + 1024] = False
        check(Vsel, norms, ok2, "invalid_block")
        # ties: copies of the winner before and after it; the first wins
        first = f // 2
        Vt, nt = Vsel.clone(), norms.clone()
        for j in (first, n - 1):
            Vt[j], nt[j] = Vsel[f], norms[f]
        check(Vt, nt, valid, "ties", expect_idx=min(first, f))
        del Vt, nt
        check(Vsel, norms, torch.zeros_like(valid), "all_invalid", expect_idx=0)

        # device time: the kernel launched directly (no wrapper host work;
        # repeated launches on one key return the same maximum), and the
        # plain version as the wrapper would run it on a CPU tensor
        q = gs.quantize_dirs(dirs, Vsel.shape[1], Vsel.dtype)
        key = torch.zeros(1, dtype=torch.int64, device="cuda")
        idx = torch.empty(1, dtype=torch.int32, device="cuda")
        score = torch.empty(1, dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (Vsel, q, norms, valid, key, idx, score)]

        def launch():
            err = lib.giga_select_launch(ptrs[0], codes[dtype], n,
                                         Vsel.shape[1] * Vsel.element_size(), *ptrs[1:],
                                         ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"giga_select_launch returned CUDA error {err}")

        k_ms = _median_ms(torch, launch)
        w_ms = _median_ms(torch, lambda: gs.giga_select(Vsel, dirs, norms, valid))
        p_ms = _median_ms(torch, lambda: gs.giga_select_ref(Vsel, dirs, norms, valid),
                          batches=5, per_batch=5)
        gbps = Vsel.numel() * Vsel.element_size() / (k_ms * 1e-3) / 1e9
        timing[(dtype, n)] = (k_ms, p_ms)
        say("select", dtype=str(dtype).replace("torch.", ""), n=n, S=S_MAIN,
            kernel_ms=f"{k_ms:.4f}", wrapper_ms=f"{w_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            kernel_GBps=f"{gbps:.1f}", checks="random,invalid_block,ties,all_invalid")
        del c, Vsel, norms, valid, dirs
        torch.cuda.empty_cache()
    return max_err, timing[(torch.int8, N_MAIN)]


def phase_build_parity(torch):
    import numpy as np
    from bayesian_coresets_tpu_torch.coresets.projector import center_lls
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import interop

    n, d, S, M = 20_000, 10, 500, 200
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-x @ np.full(d, 3.0))), 1.0, -1.0)
    z = (y[:, None] * x).astype(np.float32)
    th = (0.1 * rng.normal(size=(S, d))).astype(np.float32)
    vecs = center_lls(logistic.log_likelihood(torch.as_tensor(z), torch.as_tensor(th)))
    c_cpu = snnls.make_consts(vecs.T, vecs.sum(dim=0), select_dtype=torch.int8)
    c_gpu = interop.snnls_consts(type(c_cpu)(*(t.numpy() for t in c_cpu)), "cuda")
    t0 = time.perf_counter()
    s_cpu = snnls.build(c_cpu, snnls.init_state(c_cpu, 1024), M, 1e-6)
    t_cpu = time.perf_counter() - t0
    before = gs.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_gpu = snnls.build(c_gpu, snnls.init_state(c_gpu, 1024), M, 1e-6)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    k = int(s_cpu.size)
    ig, ic = s_gpu.idcs[:int(s_gpu.size)].cpu().numpy(), s_cpu.idcs[:k].numpy()
    if not np.array_equal(ig, ic):
        raise AssertionError(f"build parity: card selected {ig[:20]}..., CPU {ic[:20]}...")
    if gs.launches - before != int(s_gpu.itr):
        raise AssertionError("build parity: kernel launches != iterations")
    np.testing.assert_allclose(s_gpu.w.cpu().numpy(), s_cpu.w.numpy(), rtol=1e-4, atol=1e-6)
    say("build_parity", n=n, S=S, M=M, atoms=k, itr=int(s_gpu.itr), idcs="identical",
        cuda_s=f"{t_gpu:.3f}", cpu_s=f"{t_cpu:.3f}")


def phase_main(torch, smi):
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.models.laplace import laplace_approx, sample_laplace
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), N_MAIN, D_MAIN)
    lap = laplace_approx(Z, torch.ones(N_MAIN, device=dev), torch.zeros(D_MAIN, device=dev),
                         grad_fn=logistic.grad_th_log_joint,
                         hess_fn=logistic.hess_th_log_joint)
    sampler = lambda gen, n, wts, pts: sample_laplace(gen, lap, n)  # noqa: E731
    projector = bc.BlackBoxProjector(sampler, S_MAIN, logistic.log_likelihood,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    if not torch.isfinite(lap.mu).all():
        raise AssertionError("Laplace mode is not finite")

    gs.launches = 0
    t0 = time.perf_counter()
    coreset = bc.HilbertCoreset(Z, projector, select_dtype=torch.int8, max_active=1024)
    torch.cuda.synchronize()
    t_proj = time.perf_counter() - t0
    bnorm = float(coreset.snnls.consts.bnorm)
    t0 = time.perf_counter()
    coreset.build(50)
    torch.cuda.synchronize()
    t_b1 = time.perf_counter() - t0
    err50 = coreset.error() / bnorm
    t0 = time.perf_counter()
    coreset.build(M_MAIN - 50)
    torch.cuda.synchronize()
    t_b2 = time.perf_counter() - t0
    launches = gs.launches
    itr = int(coreset.snnls.state.itr)
    err = coreset.error() / bnorm
    wts, pts, idcs = coreset.get()

    if launches != itr or itr == 0:
        raise AssertionError(f"main path: {launches} select launches for {itr} iterations")
    if wts.size == 0 or not np.isfinite(wts).all() or (wts <= 0).any():
        raise AssertionError("main path: empty or non-finite coreset")
    if pts.shape != (wts.size, D_MAIN) or not np.isfinite(pts).all():
        raise AssertionError("main path: coreset points malformed")
    if not err < err50:
        raise AssertionError(f"main path: error/|b| {err} at M={itr} not below {err50} at 50")
    t_build = t_b1 + t_b2
    say("main", N=N_MAIN, D=D_MAIN, S=S_MAIN, M=M_MAIN, itr=itr, size=wts.size,
        done=coreset.reached_numeric_limit, launches=launches,
        err50=f"{err50:.6e}", err=f"{err:.6e}")
    say("main_time", setup_s=f"{t_setup:.4f}", projection_s=f"{t_proj:.4f}",
        build_s=f"{t_build:.4f}", ms_per_itr=f"{1e3 * t_build / itr:.4f}",
        points_per_s=f"{M_MAIN / (t_proj + t_build):.2f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}", card=repr(smi))
    return launches


def main() -> int:
    import torch   # noqa: F401  (fails here without PyTorch)

    if not (ROOT / "bayesian_coresets_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(bayesian_coresets_tpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    smi = phase_device(torch)
    phase_build()
    max_err, (k_ms, p_ms) = phase_select(torch)
    phase_build_parity(torch)
    launches = phase_main(torch, smi)
    if any(m == "jax" or m.startswith(("jax.", "bayesian_coresets_tpu."))
           or m == "bayesian_coresets_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    print(json.dumps({"kernels": [{
        "name": "giga_select", "route": "cuda",
        "source": "bayesian_coresets_tpu_torch/csrc/giga_select.cu",
        "replaces": "bayesian_coresets_tpu/ops/pallas_kernels.py:110",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
