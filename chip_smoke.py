#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line when it finishes; any failure raises and the
script exits non-zero without printing the final result line):

1. device: the card, and its name and power limit from nvidia-smi;
2. build: compile the kernel library from ``bayesian_coresets_tpu_torch/csrc``
   (one nvcc per source, all at once);
3. kernel against plain: the GIGA select kernel against its plain PyTorch
   version on the card, int8/bf16/f32 at (n=100k, S=500) and int8 at
   (n=1M, S=500), with invalid blocks, ties and an all-invalid input;
   median times from CUDA events;
4. packed select: the packed-int4 select kernel against its plain version
   at the probe's size (N=2^20, S=512): random directions, the winner's
   block invalid, ties, all invalid, and a row count off the block; the
   kernel, the plain version and the int8 GIGA select kernel timed on the
   same (N, S); then the probe's path (``scripts/probe_int4_torch.py``),
   int8 stream against packed stream, with its launches counted;
5. build parity: a GIGA build (int8, N=20k, S=500, M=200) on the card
   through the kernel and on the CPU through the plain version, from the
   same arrays, must select the same atoms;
6. main path at full width, bench.py's flagship build (bench.py:88-109):
   logistic data N=100k, D=10 -> BlackBoxProjector(S=500 samples
   theta ~ 0.1 N(0, I)) -> HilbertCoreset(int8 select, max_active=1024)
   .build(500), with the kernel's launch count checked against the
   iterations run;
7. NUTS on the coreset: ``mcmc.weighted.run`` on phase 6's coreset with
   1024 chains x (150 warmup + 150 draws) (bench.py:54, 319-322), checked
   for finite samples, split R-hat <= 1.05, divergences <= 1% of the
   sampling transitions, every posterior mean within 0.25 posterior sd of
   the coreset's Laplace mode and within 0.05 sd of an importance-sampled
   mean (f64, Laplace proposal).

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after.  The line before the last is the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``.  The port imports no JAX.
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
N_PROBE, S_PROBE = 1 << 20, 512                 # probe_int4_pallas.py:30
NUTS_CHAINS, NUTS_DRAWS = 1024, 150             # bench.py:54
RHAT_MAX, DIV_SHARE_MAX = 1.05, 0.01
# posterior means against the Laplace mode (which the logistic posterior's
# skew puts ~0.2 sd away) and against an importance-sampled mean (exact up
# to Monte Carlo error, ~0.01 sd at these sizes)
MEAN_SDS_MAX, IS_SDS_MAX = 0.25, 0.05


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


def _direct_ms(torch, lib_fn, *args) -> float:
    """Median device time of direct launches of a kernel entry point (no
    wrapper host work; repeated launches on one key return one maximum)."""
    def launch():
        err = lib_fn(*args)
        if err:
            raise RuntimeError(f"{lib_fn.__name__} returned CUDA error {err}")
    return _median_ms(torch, launch)


def _hold(kernel, plain, args, label, expect_idx=None):
    """A select kernel against its plain version on the same inputs: the
    index identical (and ``expect_idx`` if given), the score within
    SELECT_TOL relative (-inf exactly).  Returns (index, score error)."""
    ki, ks = kernel(*args)
    pi, pscore = plain(*args)
    ki, ks, pi, pscore = int(ki), float(ks), int(pi), float(pscore)
    if ki != pi or (expect_idx is not None and ki != expect_idx):
        raise AssertionError(f"{label}: kernel index {ki}, plain {pi}, expected {expect_idx}")
    if pscore == float("-inf"):
        if ks != pscore:
            raise AssertionError(f"{label}: kernel score {ks}, plain -inf")
        return pi, 0.0
    err = abs(ks - pscore)
    if err > SELECT_TOL * abs(pscore):
        raise AssertionError(f"{label}: score {ks} vs {pscore}")
    return pi, err


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
            f, err = _hold(gs.giga_select, gs.giga_select_ref, (Vs, dirs, nr, ok),
                           f"select {dtype} n={n} {label}", expect_idx)
            max_err = max(max_err, err)
            return f

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
        k_ms = _direct_ms(torch, lib.giga_select_launch, ptrs[0], codes[dtype], n,
                          Vsel.shape[1] * Vsel.element_size(), *ptrs[1:],
                          ctypes.c_void_p(stream))
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


def phase_packed(torch):
    import importlib.util
    from bayesian_coresets_tpu_torch.ops import _cuda_build
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps

    n, S = N_PROBE, S_PROBE
    gen = torch.Generator(device="cuda").manual_seed(3)
    V8, P = ps.make_probe_buffers(gen, n, S)
    dirs = torch.rand((S, 2), generator=gen, device="cuda") * 0.08 - 0.04
    nrminv = torch.ones(n, device="cuda")
    bias = torch.zeros(n, device="cuda")
    max_err = 0.0

    def check(Pc, nr, b, label, expect_idx=None):
        nonlocal max_err
        f, err = _hold(ps.packed_select, ps.packed_select_ref, (Pc, dirs, nr, b),
                       f"packed select {label}", expect_idx)
        max_err = max(max_err, err)
        return f

    f = check(P, nrminv, bias, "random")
    blk = f // 1024 * 1024
    b2 = bias.clone()
    b2[blk:blk + 1024] = float("-inf")
    check(P, nrminv, b2, "invalid_block")
    Pt = P.clone()
    Pt[f // 2] = P[f]
    Pt[n - 1] = P[f]
    check(Pt, nrminv, bias, "ties", expect_idx=f // 2)
    del Pt
    check(P, nrminv, torch.full_like(bias, float("-inf")), "all_invalid", expect_idx=0)
    m = n - 77
    check(P[:m], nrminv[:m], bias[:m], "odd_rows")

    lib = _cuda_build.load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    key = torch.zeros(1, dtype=torch.int64, device="cuda")
    idx = torch.empty(1, dtype=torch.int32, device="cuda")
    score = torch.empty(1, dtype=torch.float32, device="cuda")
    q4 = ps.kernel_dirs(dirs, P.shape[1])
    k_ms = _direct_ms(torch, lib.packed_select_launch, ptr(P), n, P.shape[1], ptr(q4),
                      ptr(nrminv), ptr(bias), ptr(key), ptr(idx), ptr(score), stream)
    q8 = gs.quantize_dirs(dirs, S, torch.int8)
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    i8_ms = _direct_ms(torch, lib.giga_select_launch, ptr(V8), gs._DTYPE_CODE[torch.int8], n, S,
                       ptr(q8), ptr(nrminv), ptr(valid), ptr(key), ptr(idx), ptr(score), stream)
    p_ms = _median_ms(torch, lambda: ps.packed_select_ref(P, dirs, nrminv, bias),
                      batches=5, per_batch=3)
    gb = lambda t, ms: t.numel() * t.element_size() / (ms * 1e-3) / 1e9  # noqa: E731
    say("packed_select", n=n, S=S, kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
        int8_kernel_ms=f"{i8_ms:.4f}", kernel_GBps=f"{gb(P, k_ms):.1f}",
        int8_GBps=f"{gb(V8, i8_ms):.1f}", max_abs_err=max_err,
        checks="random,invalid_block,ties,all_invalid,odd_rows")

    # the probe's path, through the wrappers, with its launches counted
    spec = importlib.util.spec_from_file_location(
        "probe_int4_torch", ROOT / "scripts" / "probe_int4_torch.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    gs.launches = ps.launches = 0
    arms = probe.run_probe(torch, V8, P)
    launches = ps.launches
    if launches == 0:
        raise AssertionError("probe path: the packed select kernel was not launched")
    say("probe_path", **{f"{a}_ms": f"{v[0]:.4f}" for a, v in arms.items()},
        **{f"{a}_GBps": f"{v[1]:.1f}" for a, v in arms.items()},
        packed_launches=launches, int8_launches=gs.launches)
    del V8, P
    torch.cuda.empty_cache()
    return launches, max_err, k_ms, p_ms


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


def _near_map_sampler(gen, n, wts, pts):
    """bench.py's projection samples (bench.py:97): theta ~ 0.1 N(0, I)."""
    import torch
    return 0.1 * torch.randn((n, D_MAIN), generator=gen, device=gen.device)


def phase_main(torch, smi):
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # this path's own peak, not phase 3's
    t0 = time.perf_counter()
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), N_MAIN, D_MAIN)
    projector = bc.BlackBoxProjector(_near_map_sampler, S_MAIN, logistic.log_likelihood,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

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
    return launches, wts, pts


def _importance_moments(torch, zc, wc, n=200_000, seed=6, inflate=1.3):
    """Posterior mean and sd of the weighted logistic coreset posterior by
    self-normalized importance sampling in f64, with the proposal
    N(mode, inflate^2 Sig) from the coreset's Laplace fit; and the
    importance sample's effective size."""
    from bayesian_coresets_tpu_torch.mcmc import weighted
    from bayesian_coresets_tpu_torch.models import logistic

    z, w = zc.double(), wc.double()
    lap = weighted.fit_laplace(logistic, z, w, z.shape[1])
    gen = torch.Generator(device=z.device).manual_seed(seed)
    u = inflate * torch.randn((n, z.shape[1]), generator=gen, dtype=torch.float64,
                              device=z.device)
    th = lap.mu + u @ lap.USig.T
    logw = (w @ logistic.log_likelihood_diff(z, th, lap.mu) + logistic.log_prior(th)
            + 0.5 * torch.sum((u / inflate) ** 2, dim=1))
    p = torch.softmax(logw, dim=0)
    mean = p @ th
    sd = torch.sqrt(p @ (th - mean) ** 2)
    return mean, sd, float(1.0 / torch.sum(p * p))


def phase_nuts(torch, smi, wts, pts):
    import numpy as np
    from bayesian_coresets_tpu_torch import mcmc
    from bayesian_coresets_tpu_torch.mcmc import nuts, weighted
    from bayesian_coresets_tpu_torch.models import logistic

    dev = torch.device("cuda")
    zc = torch.as_tensor(pts, device=dev)
    wc = torch.as_tensor(wts, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nuts.host_reads = nuts.leaf_steps = 0
    _, t, res = weighted.run(logistic, zc, wc, NUTS_DRAWS,
                             torch.Generator(device=dev).manual_seed(5),
                             num_chains=NUTS_CHAINS, target_accept=0.8, num_warmup=NUTS_DRAWS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9     # the sampler's own
    transitions = 2 * NUTS_DRAWS
    samples = res.samples                                    # (chains, draws, d)
    if samples.shape != (NUTS_CHAINS, NUTS_DRAWS, zc.shape[1]):
        raise AssertionError(f"nuts: samples of shape {tuple(samples.shape)}")
    if not torch.isfinite(samples).all():
        raise AssertionError("nuts: non-finite samples")
    rhat = float(mcmc.split_rhat(samples).max())
    min_ess = float(mcmc.ess(samples).min())
    divs = int(res.num_divergent.sum())
    flat = samples.reshape(-1, samples.shape[-1])
    mean, sd = flat.mean(dim=0), flat.std(dim=0)
    mode = weighted.fit_laplace(logistic, zc, wc, zc.shape[1]).mu
    off_mode = float((torch.abs(mean - mode) / sd).max())
    is_mean, is_sd, is_ess = _importance_moments(torch, zc, wc)
    off_is = float((torch.abs(mean.double() - is_mean) / is_sd).max())
    sd_ratio = (sd.double() / is_sd)
    say("nuts", chains=NUTS_CHAINS, warmup=NUTS_DRAWS, draws=NUTS_DRAWS, atoms=zc.shape[0],
        seconds=f"{t:.3f}", samples_per_s=f"{NUTS_CHAINS * NUTS_DRAWS / t:.1f}",
        min_ess=f"{min_ess:.1f}", min_ess_per_s=f"{min_ess / t:.1f}", max_rhat=f"{rhat:.4f}",
        divergences=divs, mean_accept=f"{float(res.accept_prob.mean()):.4f}",
        mean_tree_depth=f"{float(res.tree_depth.mean()):.3f}",
        host_reads_per_transition=f"{nuts.host_reads / transitions:.2f}",
        leaf_steps_per_transition=f"{nuts.leaf_steps / transitions:.2f}",
        peak_mem_GB=f"{peak_gb:.3f}", card=repr(smi))
    say("nuts_moments", mean_minus_mode_sds=f"{off_mode:.4f}",
        mean_minus_is_mean_sds=f"{off_is:.4f}", is_ess=f"{is_ess:.0f}",
        sd_over_is_sd=f"{float(sd_ratio.min()):.4f}..{float(sd_ratio.max()):.4f}")
    if rhat > RHAT_MAX:
        raise AssertionError(f"nuts: max split R-hat {rhat} > {RHAT_MAX}")
    if divs > DIV_SHARE_MAX * NUTS_CHAINS * NUTS_DRAWS:
        raise AssertionError(f"nuts: {divs} divergences in {NUTS_CHAINS * NUTS_DRAWS} transitions")
    if not off_mode <= MEAN_SDS_MAX:
        raise AssertionError(f"nuts: a posterior mean lies {off_mode} sd from the Laplace mode")
    if not off_is <= IS_SDS_MAX:
        raise AssertionError(f"nuts: a posterior mean lies {off_is} sd from the "
                             "importance-sampled mean")
    if not np.isfinite(min_ess) or min_ess <= 0:
        raise AssertionError(f"nuts: min ESS {min_ess}")


def main() -> int:
    import torch   # noqa: F401  (fails here without PyTorch)

    if not (ROOT / "bayesian_coresets_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(bayesian_coresets_tpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    smi = phase_device(torch)
    phase_build()
    max_err, (k_ms, p_ms) = phase_select(torch)
    packed_launches, packed_err, pk_ms, pp_ms = phase_packed(torch)
    phase_build_parity(torch)
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps
    gs.launches = ps.launches = 0
    launches, wts, pts = phase_main(torch, smi)
    if ps.launches:
        raise AssertionError("main path: the packed select kernel was launched")
    gs.launches = ps.launches = 0
    phase_nuts(torch, smi, wts, pts)
    say("nuts_launches", giga_select=gs.launches, packed_select=ps.launches)
    if any(m == "jax" or m.startswith(("jax.", "bayesian_coresets_tpu."))
           or m == "bayesian_coresets_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    print(json.dumps({"kernels": [
        {"name": "giga_select", "route": "cuda",
         "source": "bayesian_coresets_tpu_torch/csrc/giga_select.cu",
         "replaces": "bayesian_coresets_tpu/ops/pallas_kernels.py:110",
         "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms},
        {"name": "packed_select", "route": "cuda",
         "source": "bayesian_coresets_tpu_torch/csrc/packed_select.cu",
         "replaces": "scripts/probe_int4_pallas.py:73",
         "launches": packed_launches, "max_abs_err": packed_err, "ms": pk_ms,
         "plain_ms": pp_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
