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
   (n=1M, S=500), with invalid blocks, ties, an all-invalid input and (int8)
   directions on the rounding boundaries of 127 d; for every shape its
   bound (bytes over the HBM rate) and share of it, the kernel's time from
   a batch of direct launches, its cold-L2 time (a 128 MB buffer written
   before each launch, each launch between its own events, median of 50),
   and the library call that computes the two dots only (no score, no
   argmax; the port never calls it): ``torch._int_mm(Vsel, Q)`` for int8,
   ``torch.matmul(Vsel, Q)`` with TF32 off for bf16 and f32; then rows past
   the ring kernel's 4 KB through the wide-row kernel: rows of 4-48 KB (f32
   n=4096 S=12288, f32 8192 x 8192, int8 16384 x 32768, f32 n=100k S=1536
   and the linear_regression driver's f32 (10000, 10301)) and rows past 48
   KB (f32 S=12289 and 16384, bf16 S=24584, int8 S=49168, n=4096, and
   phase 17's f32 n=100k S=16384): random directions, the winner invalid,
   ties, each timed beside its bound and its library call (these matrices
   are far larger than L2, so their batch time is their cold time), and
   int8 dots past 2^24; each of the four shapes also timed in a CUDA graph
   of 20 launches (no host call between them), and kernel 1's fixed cost
   at int8 N=100k from the in-graph times at N=100k and N=1M, beside an
   empty kernel's in-graph time (``[select_fixed_cost]``);
4. packed select: the packed-int4 select kernel against its plain version
   at the probe's size (N=2^20, S=512): random directions, the winner's
   block invalid, ties, all invalid, a row count off the tile, and
   directions on the rounding boundaries; the kernel (batch and cold-L2),
   the plain version and the int8 GIGA select kernel timed on the same
   (N, S), each beside its bound (the int8 one beside ``torch._int_mm``);
   a packed row past the ring kernel's 32 KB
   (S=65568, n=4096) through the wide-row kernel; then the probe's path
   (``scripts/probe_int4_torch.py``), int8 stream against packed stream,
   with its launches counted;
5. build parity: a GIGA build and a Frank-Wolfe build (int8, N=20k, S=500,
   M=200) on the card through the kernel and on the CPU through the plain
   version, from the same arrays, must select the same atoms, once with the
   int8 select copy beside an f32 V and once from int8-resident constants
   (``make_consts_quantized``); and a GIGA build through the wide-row kernel
   (f32, N=4096, S=12289, M=50): the same atoms, or, where an f32 near-tie
   flips a select, both rows' scores printed and the errors at M within
   1e-3 relative;
6. main path at full width, bench.py's flagship build (bench.py:88-109):
   logistic data N=100k, D=10 -> BlackBoxProjector(S=500 samples
   theta ~ 0.1 N(0, I)) -> HilbertCoreset(int8 select, max_active=1024)
   .build(500), which replays CUDA graphs of 64-iteration segments, with
   the kernel's launch count (replays counted) checked against the
   iterations run; the same build in one-iteration segments on the same
   constants, which must give the same state bit for bit (372 atoms and
   error/|b| 4.479260e-02 at M=500); then a profiled window of 64
   iterations (after 65 of warm-up, as ``scripts/profile_torch_build.py``
   counts them) of each path: the select kernel's launches per iteration,
   which must be 1, all launches (a graph's kernel nodes) per iteration,
   device-busy µs and idle share, the graphs captured and their capture
   seconds, and the peak allocation.  Each GIGA (and Frank-Wolfe)
   iteration also launches the gated wscale fold (``csrc/fold_scale.cu``,
   the JAX package's ``lax.cond`` at ops/snnls.py:698), once per iteration
   run; it is held to its plain version at N=100k with the flag set and
   clear, bit for bit, and timed (direct, in a graph, plain) beside its
   bound (``[fold_kernel]``); a GIGA iteration's step, commit and gating run
   in the two single-block kernels of ``csrc/giga_step.cu`` around the select
   and the fold, 4 graph nodes an iteration in all: the update kernel's
   launches (replays counted) must equal the iterations run and the
   directions kernel's lie between them and twice them (once an iteration
   and once a segment piece), and from the build's state at 50 the two
   kernels run GIGA_STEP_HOLD_ITRS iterations in lockstep with their plain
   versions on the same inputs, every output bit for bit, then are timed
   (direct, in a graph, plain) beside their bounds
   (``[giga_step_kernels]``); then the build again on a fresh projection of
   the same shape (the projector's generator seeded 2, as bench.py's fresh
   keys) while the first coreset lives (``[main_rebuild]``): it must
   capture no graph (one graph set per shape, its graphs reading static
   copies of the constants, ``ops/graphs.py``), and its state must be its
   own one-iteration build's bit for bit; it prints the copy of its
   constants into the static copies (CUDA events, beside the bound of
   moving them), projection and build seconds, points/s and the peak
   allocation.  The first build captures at most 6 graphs: a replayed
   segment runs as pieces of power-of-two lengths (``snnls.pieces``), at
   most 14 per graph set.  After phase 8, with the first coreset and its
   rebuild dropped (their layout's static copies and sets retired, not
   freed), the build is walked over ``coreset_size_grid(500, 7, "log")``'s
   increments, as the drivers build, on a fresh projection (seeded 3) and
   then another (seeded 4) (``[main_regrid]``): the first walk revives the
   retired set and captures at most the pieces it lacks (14 keys in all),
   the second captures nothing, and each equals its one-iteration walk bit
   for bit (graphs captured, revivals, retained bytes, seconds, ms per
   iteration and host reads per walk);
7. NUTS on the coreset: ``mcmc.weighted.run`` on phase 6's coreset with
   1024 chains x (150 warmup + 150 draws) (bench.py:54, 319-322), checked
   for finite samples, split R-hat <= 1.05, divergences <= 1% of the
   sampling transitions, every posterior mean within 0.25 posterior sd of
   the coreset's Laplace mode and within 0.05 sd of an importance-sampled
   mean (f64, Laplace proposal).  Its transitions replay CUDA graphs
   (``mcmc/nuts.py::Transitions``; ms per transition, host reads and leaves
   per transition, graphs captured and their capture and instantiate
   seconds, peak allocation); then a short run (1024 chains x (20 + 20))
   replayed and direct (``graphs=False``) from one seed must agree bit for
   bit (``[nuts_parity]``), and a window of 20 transitions from the run's
   last draws, direct and replayed, is timed and profiled as
   ``scripts/profile_torch_nuts.py`` does it (``[nuts_window]``: wall ms,
   device-busy ms and idle share per transition, kernels or graph nodes
   per transition and per leaf, host reads, graphs, peak allocation; the
   two states after it bit for bit);
8. optimize: ``HilbertCoreset.optimize()`` (FISTA on the card, one
   captured CUDA graph) on phase 6's coreset, after NUTS has sampled it:
   the error must not rise and nothing may latch; the same solve again, a
   replay of that graph, timed beside the first call and its capture; then the exact host solver on the same active set must reach
   the FISTA error within 1e-3; then ``optimize()`` on phase 6's rebuild
   (``[optimize_rebuild]``), which captures nothing at the first's padded
   size and must give the same solve's weights run uncaptured bit for bit;
9. SparseVI at bench.py's canonical config (bench.py:211-231: N=1000,
   d=200, S=100, 50 Adam steps per select, M=30, 32 slots, the posterior
   basis sampler, step 1/(1+i)), black-box and with the exact Gaussian
   family, and the scaled arm of scripts/bench_svi_tpu.py:134-135 (N=100k,
   1024-row subsamples).  Each build runs twice, its Adam steps replayed
   as CUDA graphs (``ops/opt.py``, the default) and direct
   (``graphs=False``), each after a warm-up build of its own (the
   replayed one captures): weights, indices, points and the generator's
   state after must agree bit for bit.  Each path prints build seconds,
   µs per Adam step, host reads per build and where, graphs captured and
   their capture and instantiate seconds, and a profiled window of one
   optimize (50 Adam steps: µs, graph nodes or kernels and device-busy µs
   per step, idle share); each checked for finite nonnegative weights,
   unique indices, size <= M, one host read per select and none per Adam
   step, and rKL (f64 host closed form) within 1.5x the largest of three
   seeds of the JAX package at the same config on a CPU;
10. SparseVI card against CPU: the exact family at the canonical config on
   both, from the same data and basis: identical index sequences, weights
   within rtol 1e-3;
11. BatchPSVI at scripts/bench_svi_tpu.py:138-157's config (N=100k, d=20,
   S=200, sz=100, 20000-row subsamples, 500 joint Adam steps, black-box),
   replayed and direct as phase 9's builds (bit for bit, the same numbers
   per path); finite, no host read, and both rKL and error() below those
   of its initialization;
12. Frank-Wolfe at full width: phase 6's data and projection,
   ``HilbertCoreset(snnls=FrankWolfe).build(500)``: one select launch per
   iteration, ms per iteration, error()/|b| at M (443 atoms), and as in
   phase 6 the one-iteration build bit for bit and a profiled window of
   each path with the select's share of the device time;
13. OMP on the same projection, 100 iterations with max_active=128: one
   select launch per iteration, the error printed every 25 iterations must
   not rise, ms per iteration and the share of it that the 256-step FISTA
   re-solve takes, the graphs (segments of 4 iterations) captured and their
   capture seconds, and a profiled window of 16 replayed iterations;
14. importance and uniform sampling on the same projection, 500 draws each:
   no kernel launch, the counts sum to 500, finite nonnegative weights and
   error(), ms per draw, launches and host reads per draw, graphs captured;
15. the Poisson model: ``poisson.gen_synthetic`` at N=100k ->
   BlackBoxProjector (S=500) -> a GIGA build (M=200) -> ``mcmc.weighted.run``
   on the coreset with 256 chains x (100 + 100), held to phase 7's gates
   (finite, split R-hat <= 1.05, divergences <= 1%);
16. the streamed int8-resident build at full width, bench.py's N=8M arm
   (bench.py:127-196): logistic data N=8M, D=10 kept on the host ->
   ``HilbertCoreset(stream_chunk_size=1M, max_active=1024)`` (phase 6's
   projection samples) -> ``.build(500)`` (GIGA): construction and build
   seconds from ``utils/profiling.py``, ms per iteration, error()/|b|, one
   select launch per iteration, as in phase 6 the one-iteration build bit
   for bit and a profiled window of each path, the peak allocation, which
   must stay below the 16 GB of an f32 (N, S) matrix, and the fold kernel
   held and timed at N=8M as in phase 6, its plain version's O(N) multiply
   and the kernel each as a share of the iteration (``[streamed_fold]``),
   and the fused GIGA step's kernels held and timed on int8-resident rows as
   in phase 6 (``[streamed_giga_step_kernels]``); the select on that 4.1 GB int8 matrix held against its plain
   version (in 2^20-row blocks) and timed beside its bound (share >= 0.5)
   and ``torch._int_mm``; the N=1M quality arm (the in-memory int8 select
   against the streamed path from the same data and projector: int8 rows
   equal but for ±1, norms within rtol 1e-5, and the streamed error at
   M=500 below max(2x the in-memory one, 0.05 x the initial one), the JAX
   package's rule); OMP (25 iterations, max_active=128) and importance
   sampling (200 draws) from the N=1M int8-resident constants;
17. a Hilbert build through the wide-row kernel: phase 6's data ->
   BlackBoxProjector(S=16384 samples theta ~ 0.1 N(0, I), bench.py:97's
   rule at a user-chosen projection size) -> ``HilbertCoreset(max_active=
   1024)`` with the default f32 select copy (V itself, 6.55 GB, rows of 64
   KB) -> ``.build(200)`` with GIGA, then the same with
   ``snnls=FrankWolfe``: ms per iteration, one select launch per iteration,
   error()/|b| at M (finite, no larger than after the first iteration;
   GIGA 182 atoms), the peak allocation, and as in phase 6 the
   one-iteration build bit for bit and a profiled window of each path with
   the select's device µs per iteration beside its bound; the fused GIGA
   step's kernels held and timed at S=16384 as in phase 6
   (``[wide_giga_step_kernels]``);
18. the experiment drivers through their ``main([...])`` entry points, each
   in a temporary working directory: ``logistic_poisson`` GIGA-OPT at the
   reference's logistic settings (S=500, M up to 1000, 8 NUTS chains, max
   tree depth 15, target accept 0.9) on N=100k, D=10 data made from a seed
   and read through ``BC_DATA_DIR``, its NUTS draws and warm-up cut to
   EXP_MCMC and its 7 sizes to EXP_SIZES, checked through the port's
   ``load_matching`` (finite columns, rKL falling with M, nonempty
   coresets, finite positive weights); then in the same directory (its
   full-data chains cached) ``--alg SVI`` and ``--alg BPSVI``, their
   sizes cut to 1, 10, 100 (each select, and each BatchPSVI size, is 100
   Adam steps over the full data, replayed as CUDA graphs), each with an
   ``[experiments]`` line of its own: seconds and their split (build,
   NUTS), Adam steps run and build µs per step, the host reads made inside
   the Adam steps (must be 0), graphs captured and their seconds,
   ``reduced=``; checked for finite columns, nonempty coresets, finite
   nonnegative weights, finite rKL, and for SVI rKL at M_max below rKL at
   the first size;
   then there ``--alg GIGA-REAL`` and ``--alg US``;
   ``simple_lr`` at its defaults; ``linear_regression --alg GIGA-OPT-EXACT``
   at its defaults on the card and with ``--device cpu``, held together;
   ``synthetic_vectors`` at its defaults with GIGA and FW, OMP at M=100, and
   US; ``linear_regression``'s SVI and SVI-EXACT (sizes cut to EXP_LR_SVI_M;
   both replay their Adam steps, no host read in them), SVI-EXACT again at
   the driver's M=300 (its Adam steps cut to EXP_LR_FULL_OPT a select; the
   slots round up to 512, past d=301, so its steps take the QR refit, as
   in the JAX package), with a ``[linreg_refit]`` line on the first 30 and
   300 slots of the two coresets (the low-rank refit against the f64 eigh
   form and the QR posterior, its square root's residual, µs per call in a
   CUDA graph beside the replaced eigh refit's direct µs), GIGA-OPT,
   GIGA-REAL, GIGA-REAL-EXACT (card against CPU) and US;
   the Gaussian experiment's eight algorithms at its defaults, its two
   exact-family GIGA runs on CPU-drawn data and subsample, card against
   CPU; ``logistic_poisson --model poiss`` on N=100k Poisson rows made from
   a seed (and a held-out set): GIGA-OPT, GIGA-REAL, US, then SVI and
   BPSVI at sizes 1 and 10.  Every run with a select copy holds kernel 1 to
   its plain version on it; every replayed Adam run makes no host read in
   its Adam steps; sampled runs' rKL falls with M (not BatchPSVI's).
   One ``[experiments]`` line per driver (seconds, select launches,
   iterations, metrics at M_max, the split of logistic_poisson's time,
   the graphs captured and their capture seconds, ``reduced=``;
   linear_regression's also the select's time per launch on its own select
   copy, beside its bound); one select launch per GIGA/FW/OMP iteration
   run (``snnls.itrs_run``: after ``done`` latches inside a segment, its
   gated iterations still select), none of the packed kernel.  Each run
   also prints its captures by kind (``build``, ``optimize``, ``nn_opt``,
   ``nuts``) and their seconds (``[experiments_graphs]``), and fails if it
   captures a ``build`` graph where an earlier run had built with the same
   graph sets (layout, method, ``tol``) over the same size grid, or more
   than 14 per set it built with;
19. the sharded paths over ``torch.distributed`` on the one card (first
   ``graphs.release()`` drops the retired graph sets and their static
   copies, memory reserved printed before and after: ``[release]``), each
   rank a process spawned by ``parallel.run_local`` (loading phase 2's
   library): (a) a 1-rank NCCL group runs ``HilbertCoreset(mesh=)`` at
   phase 6's config, which must give phase 6's atoms and weights bit for
   bit with one select launch per iteration (ms, launches, exchanges and
   bytes per iteration beside phase 6's, and a profiled window), then
   ``build_sharded`` on the same projection; (b) two ranks over gloo (NCCL
   refuses two ranks on one card): ``build_sharded`` bit-identical to
   (a)'s, phase 16's N=1M stream with each rank projecting its own rows
   (rows and norms against phase 16's, differing rows counted, the JAX
   error rule, weights bit-identical where no row differs), the exchanges
   per iteration equal at N=100k and N=1M, and weighted NUTS on phase 6's
   coreset at 256 chains x (50 + 50), 128 per rank, pooled (the first 5
   transitions within 1e-5 of one process; phase 7's R-hat, divergence and
   importance-sampling checks).  (b)'s times measure gloo, not NCCL;
20. the proj axis, two-axis meshes and row-sharded SparseVI and BatchPSVI,
   ranks spawned as in phase 19, over gloo.  First the proj axis's two
   kernels alone at (c)'s and (d)'s local shapes: the select's dots-only
   mode (``giga_dots``: int32 dots equal to the plain version's, f32 within
   1e-5) and the score of summed dots (``giga_score_select``: the index
   identical, random, ties, all invalid, and the fused select's result bit
   for bit on unsplit dots), each timed in a batch and cold beside its
   bound and, for the dots, ``torch._int_mm`` or ``torch.matmul`` (TF32
   off); the score kernel also beside its floor, an empty kernel launched
   by the same host path and timed the same ways, and both in a CUDA graph
   of 20 launches (device time without the host's calls).  (c) two ranks:
   ``{"proj": 2}`` GIGA and Frank-Wolfe at phase 6's config (local blocks
   (100000, 256) int8) against phases 6 and 12 (the first slot where their
   atoms part, if any; the same atoms need the
   weights within rtol 1e-4, atol 1e-5 of the largest), then ``{"data":
   2}`` SparseVI at phase 9's canonical exact arm and its N=100k sub-1024
   arm, and BatchPSVI at phase 11's config with 100 Adam steps, each
   against the single-process run of the same seed in this phase (the same
   indices, weights within rtol 1e-3); (d) four ranks: ``{"data": 2,
   "proj": 2}`` GIGA at phase 17's config (f32, S=16384; local blocks
   (50000, 8192)) against phase 17, then weighted NUTS on ``{"data": 2,
   "chains": 2}`` at phase 19's 256 chains x (50 + 50), held as phase 19
   holds it.  Each build prints ms per iteration, dots and score launches
   per iteration (one each), a profiled window's launches (GIGA), the
   exchanges and bytes per iteration by axis (one (n_loc, 2) block of
   dots per select on the proj axis) and each rank's peak allocation.

Phases 8-11 and 14, and phase 18's SparseVI and BatchPSVI runs, launch
no hand-written kernel: the JAX package computes SparseVI, BatchPSVI, the
re-solve and the sampling solvers with plain XLA ops.  On the card ``snnls.build`` replays CUDA graphs
(``bayesian_coresets_tpu_torch/ops/graphs.py``), and a replay adds the
select launches its capture recorded to the kernels' counts; phase 5's
wide-row build (which reads each pick back) and the sharded builds of
phases 19-20 (never captured) run one-iteration segments.  Every path is driven with the kernels' launch counts set to 0 just
before it and read just after; the kernels' ``launches`` are the sums over
the paths that select through them (phases 6, 12, 13, 15-19, and phase
20's proj-sharded builds for ``giga_dots`` and ``giga_score_select``;
phases 19 and 20's ranks count their own); the fused GIGA step's are the
sums over phases 6, 12-14, 16 and 17, which hold them to the GIGA iterations
run (none in Frank-Wolfe, OMP and the sampling solvers).  The line before
the last is the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``.  The port imports no JAX,
no pandas and no matplotlib.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SELECT_TOL = 1e-6           # relative score tolerance, kernel against plain
# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
COLD_REPS = 50
FLUSH_BYTES = 128 << 20     # written before each cold-L2 launch (L2 is 50 MB)
PROFILE_ITRS = 64           # GIGA iterations in phase 6's profiled window
# the fused GIGA step's kernels held to their plain versions in lockstep
GIGA_STEP_HOLD_ITRS = 8
# their launches over the paths that count them (_fused_count)
FUSED_LAUNCHES = {"update": 0, "dirs": 0}
N_MAIN, D_MAIN, S_MAIN, M_MAIN = 100_000, 10, 500, 500
# phases 6, 12 and 17's atoms (weights > 0) at M and phase 6's error/|b|
# at M: the values these builds have given on the H100 since they were added
MAIN_ATOMS, FW_ATOMS, WIDE_GIGA_ATOMS, MAIN_ERR = 372, 443, 182, "4.479260e-02"
# phase 6's first build, 50 then 450 iterations: the pieces (snnls.pieces) of
# its segments, 32r + 16 + 2, 8 + 4 + 2, 64r and 32r + 16 + 4 (r: refreshing)
MAIN_PIECES = 6
# a graph set's most keys: pieces of 1-64 iterations, refreshing or not
SET_KEYS_MAX = 14
N_PROBE, S_PROBE = 1 << 20, 512                 # probe_int4_pallas.py:30
NUTS_CHAINS, NUTS_DRAWS = 1024, 150             # bench.py:54
NUTS_SHORT, NUTS_WINDOW = 20, 20    # phase 7's replayed-against-direct run; profiled windows
RHAT_MAX, DIV_SHARE_MAX = 1.05, 0.01
# posterior means against the Laplace mode (which the logistic posterior's
# skew puts ~0.2 sd away) and against an importance-sampled mean (exact up
# to Monte Carlo error, ~0.01 sd at these sizes)
MEAN_SDS_MAX, IS_SDS_MAX = 0.25, 0.05
# SparseVI (bench.py:211-231, scripts/bench_svi_tpu.py:134-135) and BPSVI
# (scripts/bench_svi_tpu.py:138-157)
SVI_N, SVI_D, SVI_S, SVI_M, SVI_OPT, SVI_CAP = 1000, 200, 100, 30, 50, 32
SVI_N_SCALED, SVI_SUB_SCALED = 100_000, 1024
BP_N, BP_D, BP_S, BP_SZ, BP_SUB, BP_STEPS = 100_000, 20, 200, 100, 20_000, 500
# rKL at M=30 of the JAX package's svi_build at the same configs, on a CPU
# (keys 2, 3, 4; f64 host closed form as _rkl64): the largest of the three.
# The port's data is drawn from another stream, so it is held within 1.5x.
JAX_RKL_MAX = {"canonical_blackbox": 1162.0726287995294,
               "canonical_exact": 542.2950201551715,
               "scaled_N100k_sub1024": 136240.48075067793}
RKL_SLACK = 1.5
PROFILE_STEPS = 50          # Adam steps in each profiled window (one of phase 9's optimizes)
# rows of 4-48 KB, past the ring kernel's 4 KB: (dtype, n, S): 48 KB, 32 KB
# and 32 KB int8 rows (the shapes where the ring kernel lost to its
# library call or ran at 32-59% of its bound), 6 KB rows at phase 6's N,
# and the linear_regression driver's f32 select (N=10000, d + p^2 = 301 +
# 100^2 columns, 41216-byte rows)
MID_SELECT = [("float32", 4096, 12288), ("float32", 8192, 8192), ("int8", 16384, 32768),
              ("float32", 100_000, 1536), ("float32", 10_000, 10_301)]
# rows past 48 KB (packed 32 KB): (dtype, n, S)
WIDE_N = 4096
WIDE_SELECT = [("float32", WIDE_N, 12289), ("float32", WIDE_N, 16384),
               ("bfloat16", WIDE_N, 24584), ("int8", WIDE_N, 49168),
               ("float32", 100_000, 16384)]          # phase 17's select
WIDE_PACKED_S = 65568       # a 32784-byte packed row
# phase 5's card-against-CPU build through the wide-row kernel (f32 select)
WIDE_PARITY_N, WIDE_PARITY_S, WIDE_PARITY_M = 4096, 12289, 50
# phase 17: a Hilbert build at a user-chosen projection past the ring's 48 KB
WIDE_BUILD_S, WIDE_BUILD_M = 16384, 200
OMP_ITRS, OMP_ACTIVE, OMP_CHUNK = 100, 128, 25
SAMPLING_DRAWS = 500
POIS_M, POIS_CHAINS, POIS_DRAWS = 200, 256, 100
# the streamed int8-resident build (bench.py:127-196): N=8M in 1M-row chunks,
# and the N=1M quality arm (bench.py's N=1M arm) in 250k-row chunks
STREAM_N, STREAM_CHUNK = 8_000_000, 1_000_000
QUALITY_N, QUALITY_CHUNK = 1_000_000, 250_000
STREAM_MEM_MAX = 16.0e9     # bytes of the f32 (N, S) matrix alone at N=8M
STREAM_OMP_ITRS, STREAM_OMP_ACTIVE, STREAM_OMP_CHUNK = 25, 128, 5
STREAM_DRAWS = 200
# phase 18: the experiment drivers.  logistic_poisson runs the reference's
# logistic settings (main.py:255-259; the JAX driver's defaults) on N=100k
# rows of D=10 (bench.py:50's width) made from a seed: N(0, 1) covariates,
# the intercept last, theta = 1, labels +-1.  Cut: the NUTS draws and
# warm-up (10000 each by default; NUTS is 96-98% of the run) and then the
# sizes, 7 -> 4 (1, 10, 100, 1000): at 256 draws the min ESS sat at the
# gate of 100 and the dense retry fired at 4 of 7 sizes; OMP's sizes (each
# iteration is 256 FISTA steps).  Everything else runs at the defaults.
EXP_N, EXP_D, EXP_SEED = 100_000, 10, 18
EXP_MCMC, EXP_SIZES = 400, 4
EXP_LP_ARGV = ["--model", "lr", "--dataset", "synth_lr_N100k", "--alg", "GIGA-OPT",
               "--proj_dim", "500", "--coreset_size_max", "1000",
               "--coreset_num_sizes", str(EXP_SIZES),
               "--coreset_size_spacing", "log", "--max_treedepth", "15",
               "--target_accept", "0.9", "--mcmc_chains", "8", "--trial", "1",
               "--mcmc_samples_full", str(EXP_MCMC), "--mcmc_samples_coreset", str(EXP_MCMC)]
EXP_OMP_M = 100
# logistic_poisson --alg SVI and --alg BPSVI: the same data and
# settings (opt_itrs 100, step inv, the full data for every Adam step, as
# the reference's drivers), the sizes cut to 1, 10, 100: every SparseVI
# select, and every BatchPSVI size, is 100 Adam steps of ~2.1 ms (the
# (N, S) = (100k, 500) projection of every step)
EXP_ADAM_M, EXP_ADAM_SIZES, EXP_ADAM_OPT = 100, 3, 100
# linear_regression GIGA-OPT-EXACT, card against CPU: the grid points whose
# support is below proj_dim agree within EXP_LR_RTOL (f32 features, f64
# metrics); past it the residual is rounding noise and both are held to the
# same bounds, 6-11x the CPU's own values there (rKL 6.6, fKL 4.6, mean
# error 0.079, covariance error 0.036, on a CPU)
EXP_LR_RTOL = 1e-3
EXP_LR_TAIL = {"rklw": 50.0, "fklw": 50.0, "mu_errs": 0.5, "Sig_errs": 0.25}
# synthetic_vectors GIGA and FW, card against CPU: below data_dim the same
# sizes, and errors within EXP_SV_RTOL of the CPU's plus EXP_SV_ATOL of the
# run's largest error (f32 rounding of the residual, which cancels as it
# shrinks: the JAX package and the port on a CPU differ by up to 1.2e-4 at
# GIGA's 90 atoms, err 1.42 of a largest 877); past it the residual is
# rounding noise, and each run's error at M_max is held to its error at the
# last size below data_dim
EXP_SV_RTOL, EXP_SV_ATOL = 1e-4, 1e-6
# phase 18's other configurations: every algorithm of each driver that the
# runs above leave out, at the drivers' defaults but for the cuts that each
# [experiments] line lists in reduced=.  The Gaussian experiment
# (examples/gaussian/main.py's defaults): N=1000, d=200, proj_dim 100, M up to
# 200 over 7 sizes, 100 Adam steps per SparseVI select or BatchPSVI size
EXP_G_N, EXP_G_D, EXP_G_PROJ, EXP_G_M = 1000, 200, 100, 200
# its exact-family GIGA runs, card against CPU on the same CPU-drawn data and
# subsample (the driver draws both on its device): EXP_LR_RTOL below
# proj_dim, and each run's metrics at M_max within these bounds, 6.8-7.8x the
# larger of the two runs' values on a CPU (GIGA-REAL-EXACT's rKL 6.52, fKL
# 6.37, mean error 0.0080; GIGA-OPT-EXACT's covariance error 0.037)
EXP_G_TAIL = {"rklw": 50.0, "fklw": 50.0, "mu_errs": 0.05, "Sig_errs": 0.25}
EXP_G_EXACT = ("GIGA-OPT-EXACT", "GIGA-REAL-EXACT")
# linear_regression SVI and SVI-EXACT: 100 Adam steps per select over all
# N=10000 rows, so M is cut (300 -> EXP_LR_SVI_M, its sizes to
# EXP_LR_SVI_SIZES); SVI-EXACT also runs at the driver's M=300 with its Adam
# steps cut to EXP_LR_FULL_OPT a select (3000 steps, about M=30's 2900)
EXP_LR_SVI_M, EXP_LR_SVI_SIZES = 30, 4
EXP_LR_FULL_OPT = 10
# [linreg_refit] bounds on the SVI-EXACT coresets' slots (d = 301), 5x the
# CPU tests' (tests/test_torch_linreg.py WIDE_TOL): F against the f64 eigh
# form (relative, Frobenius), F F^T and the mean against the QR posterior
# (largest entry's error over the largest entry), the square root's residual
LR_REFIT_TOL = {"F_eigh": 1e-7, "Sig_qr": 1e-8, "mu_qr": 1e-6, "residual": 5e-9}
# linear_regression GIGA-REAL-EXACT, card against CPU as GIGA-OPT-EXACT
# above; its tail bounds are 10-14x its values at M_max on a CPU (rKL 3.5e5,
# fKL 3524, mean error 2.39, covariance error 0.22: the exact family fit to
# the realistic subsample's 100 rows)
EXP_LR_REAL_TAIL = {"rklw": 5e6, "fklw": 5e4, "mu_errs": 25.0, "Sig_errs": 2.5}
# logistic_poisson --model poiss: N=EXP_N training rows and EXP_POIS_NT held
# out (_poisson_data), the runs of EXP_LP_ARGV; SVI and BPSVI at sizes 1, 10
EXP_LP_DATASETS = {"lr": "synth_lr_N100k", "poiss": "synth_poiss_N100k"}
EXP_POIS_NT = 10_000
EXP_POIS_ADAM_M, EXP_POIS_ADAM_SIZES = 10, 2
# sampled runs draw their own numbers on the card, so they are held on the
# quality that the reference's figures show, rKL falling with M: at M_max
# below EXP_RKL_FALL x the first size's for logistic_poisson (its first size
# is one atom and its rKL comes from 400 NUTS draws: SparseVI at sizes 1 and
# 10 fell to 0.21 of it on an H100 with --model poiss, and to 0.53 on a CPU
# with the logistic model at N=20k, so only the fall itself is held), and
# below EXP_RKL_FALL_CLOSED x the first size's for the closed-form drivers
# (their first size is the empty coreset) and for synthetic_vectors' error
# (the largest ratios on an H100: 0.032, synthetic_vectors US; 0.0097, the
# Gaussian GIGA-OPT); BatchPSVI rebuilds at each size and is held to finite
# values only
EXP_RKL_FALL, EXP_RKL_FALL_CLOSED = 1.0, 0.1
# phase 19: the sharded paths on the one card.  (a) a 1-rank NCCL group at
# phase 6's config; (b) two gloo ranks: build_sharded on phase 6's
# projection, the N=1M stream of phase 16 (its chunk), and weighted NUTS on
# phase 6's coreset at 256 chains x (50 + 50) with pooled adaptation (cut
# from 100 + 100 when phase 20 came: the script's time)
SHARD_CFG = dict(dev="cuda", backend_a="nccl", N=N_MAIN, M=M_MAIN, QN=QUALITY_N,
                 QCHUNK=QUALITY_CHUNK, chains=256, draws=50, profile=True)
# phase 20: the proj axis, two-axis meshes and row-sharded SparseVI and
# BatchPSVI on the one card, ranks over gloo.  (c) two ranks: {"proj": 2}
# GIGA and Frank-Wolfe at phase 6's config (int8 select; local blocks
# (100000, 256)), then {"data": 2} SparseVI at phase 9's canonical exact arm
# and its N=100k sub-1024 arm, and BatchPSVI at phase 11's config with its
# Adam steps cut from 500 to 100; (d) four ranks: {"data": 2, "proj": 2}
# GIGA at phase 17's config (f32 select, S=16384, M=200; local blocks
# (50000, 8192), 1.64 GB), then weighted NUTS on {"data": 2, "chains": 2}
# at phase 19's 256 chains x (50 + 50) on phase 6's coreset
PROJ_CFG = dict(dev="cuda", N=N_MAIN, M=M_MAIN, WS=WIDE_BUILD_S, WM=WIDE_BUILD_M,
                svi_n=SVI_N, svi_n_scaled=SVI_N_SCALED, bp_n=BP_N, bp_sub=BP_SUB, bp_steps=100,
                chains=256, draws=50, profile=True, kernels=True)
# the proj axis's kernels alone, at (c)'s and (d)'s local shapes: (dtype, n, S)
PROJ_KERNEL_SHAPES = [("int8", N_MAIN, 250), ("float32", N_MAIN // 2, WIDE_BUILD_S // 2)]
# a proj-sharded build against its single-process run: the same atoms, the
# weights within rtol 1e-4, atol 1e-5 of the largest (f32 partial dots
# summed in another order; the JAX package's bar, tests/test_parallel.py:37-
# 44); where the atoms part, the errors at M within PROJ_ERR_RTOL
PROJ_ERR_RTOL = 1e-2
# row-sharded SparseVI and BatchPSVI against one process on the card: phase
# 10's bar for sums taken in another order (the same indices, rtol 1e-3)
SVI_SHARD_RTOL = 1e-3


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


def _launcher(lib_fn, *args):
    def launch():
        err = lib_fn(*args)
        if err:
            raise RuntimeError(f"{lib_fn.__name__} returned CUDA error {err}")
    return launch


def _direct_ms(torch, lib_fn, *args) -> float:
    """Median device time of direct launches of a kernel entry point (no
    wrapper host work; each launch leaves its workspace zero for the next)."""
    return _median_ms(torch, _launcher(lib_fn, *args))


_flush = []


def _graph_ms(torch, make, per_graph: int = 20, reps: int = 7) -> float:
    """Median device time per launch of ``per_graph`` launches captured in
    one CUDA graph on a side stream (no host work between the launches):
    ``make(stream_handle)`` returns a launcher on that stream."""
    st = torch.cuda.Stream()
    launch = make(st.cuda_stream)
    with torch.cuda.stream(st):
        launch()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=st):
        for _ in range(per_graph):
            launch()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    times.sort()
    return times[len(times) // 2]


def _cold_ms(torch, fn, reps: int = COLD_REPS) -> float:
    """Median device time of single calls, each after FLUSH_BYTES were
    written (so nothing of the inputs is left in L2) and each between its
    own pair of CUDA events."""
    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        _flush[0].fill_(i & 0xFF)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _bound(nbytes: int, ops: int, kind: str):
    """The least time the card could take (ms), and what bounds it: every
    input byte read once and every output byte written once at the HBM
    rate, against the operations at the peak rate of ``kind``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _select_bound(torch, Vsel, S):
    """Bound of one GIGA select over ``Vsel`` with S directions: Vsel, the
    valid bytes, the norms (read for bf16/f32 only), the f32 directions
    and the (idx, score) out; a multiply and an add per element and
    direction."""
    n, Sp = Vsel.shape
    nbytes = Vsel.numel() * Vsel.element_size() + n + S * 2 * 4 + 8
    if Vsel.dtype != torch.int8:
        nbytes += 4 * n
    return _bound(nbytes, 4 * n * Sp, str(Vsel.dtype).replace("torch.", ""))


def _half_integer_dirs(torch, k):
    """(S, 2) f32 directions d on the card with 127 d == k exactly in f32,
    for the half-integer (S, 2) tensor k."""
    import numpy as np
    k = k.cpu().numpy().astype(np.float32)
    d = (k / np.float32(127.0)).astype(np.float32)
    for cand in (np.nextafter(d, np.float32(np.inf)), np.nextafter(d, np.float32(-np.inf))):
        off = (d * np.float32(127.0)).astype(np.float32) != k
        d[off] = cand[off]
    if not ((d * np.float32(127.0)).astype(np.float32) == k).all():
        raise AssertionError("no f32 direction on a rounding boundary")
    return torch.as_tensor(d, device="cuda")


def _boundary_dirs(torch, S, seed):
    """127 d exactly on +-0.5, +-1.5, +-2.5: the kernels' own quantization
    must round half to even, as torch.round does."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return _half_integer_dirs(torch, torch.randint(-3, 3, (S, 2), device="cuda",
                                                   generator=gen) + 0.5)


def _int_mm_ms(torch, Vsel, dirs):
    """The yardstick: ``torch._int_mm`` of the int8 copy against Q, the two
    quantized directions and six zero columns (cuBLASLt's smallest width);
    it computes the dots only.  Returns (ms, how) or (None, why not)."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    Q = torch.zeros((8, Vsel.shape[1]), dtype=torch.int8, device=Vsel.device)
    Q[:2] = gs.quantize_dirs(dirs, Vsel.shape[1], torch.int8)
    why = []
    for layout, B in (("Q_col_major", Q.T), ("Q_row_major", Q.T.contiguous())):
        try:
            torch._int_mm(Vsel, B)
            torch.cuda.synchronize()
        except RuntimeError as e:
            why.append(f"{layout}:{str(e).splitlines()[0][:60]}".replace(" ", "_"))
            continue
        return _median_ms(torch, lambda: torch._int_mm(Vsel, B)), layout
    return None, "refused(" + ";".join(why) + ")"


def _library_ms(torch, Vsel, dirs):
    """The library call that computes the select's two dots (and nothing
    else: no score, no argmax; the port never calls it): int8
    ``torch._int_mm`` (``_int_mm_ms``), bf16 and f32 ``torch.matmul(Vsel,
    Q)`` with Q the (Sp, 2) directions in Vsel's type, TF32 off.  Returns
    (ms, how) or (None, why not)."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    if Vsel.dtype == torch.int8:
        return _int_mm_ms(torch, Vsel, dirs)
    Q = gs.quantize_dirs(dirs, Vsel.shape[1], Vsel.dtype).T
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _median_ms(torch, lambda: torch.matmul(Vsel, Q)), "matmul_tf32_off"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _hold(kernel, plain, args, label, expect_idx=None, scale=None):
    """A select kernel against its plain version on the same inputs: the
    index identical (and ``expect_idx`` if given), the score within
    SELECT_TOL relative (-inf exactly); with ``scale``, within SELECT_TOL of
    the larger of the score and ``scale(args, index)[1]``, the size of the
    absolute products that f32 sums in two orders round at (``_f32_scale``).
    Returns (index, score error)."""
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
    size = abs(pscore) if scale is None else max(abs(pscore), scale(args, pi)[1])
    if err > SELECT_TOL * size:
        raise AssertionError(f"{label}: score {ks} vs {pscore}")
    return pi, err


def _f32_scale(torch, args, f):
    """For an f32 or bf16 select: row f's score in f64, and the same score
    from the sums of absolute products, (sum |v q0| + sum |v q1|) / (|v|
    sqrt(1 - d1^2)).  f32 sums of one row in two orders differ by a few
    ulps of the latter, which is far larger than the score where the dot
    cancels (a near-orthogonal winner among many rows)."""
    import math
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    V, dirs, norms = args[0], args[1], args[2]
    q = gs.quantize_dirs(dirs, V.shape[1], V.dtype).double()
    v, nr = V[f].double(), float(norms[f])
    d = (q @ v) / nr
    den = math.sqrt(max(1.0 - float(d[1]) ** 2, 1e-30))
    return float(d[0]) / den, float((q.abs() @ v.abs()).sum()) / nr / den


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


def _hold_wide(torch, kernel, plain, args, kill, label, scale=None):
    """A wide-row select against its plain version: random directions, the
    winner dead (``kill(args, f)`` returns the inputs with row f invalid),
    and copies of the winner before and after it (the first wins).  Returns
    the largest score error."""
    n = args[0].shape[0]
    f, err = _hold(kernel, plain, args, f"{label} random", scale=scale)
    f2, e2 = _hold(kernel, plain, kill(args, f), f"{label} invalid_winner", scale=scale)
    if f2 == f:
        raise AssertionError(f"{label}: the dead row {f} was selected")
    tied = list(args)
    tied[0], tied[2] = args[0].clone(), args[2].clone()
    first = f // 2 if f > 1 else f
    for j in (first, n - 1):
        tied[0][j], tied[2][j] = args[0][f], args[2][f]
    _, e3 = _hold(kernel, plain, tied, f"{label} ties", expect_idx=min(first, f), scale=scale)
    return max(err, e2, e3)


def _kill(args, f):
    """A select's inputs with row f invalid."""
    ok = args[3].clone()
    ok[f] = False
    return [*args[:3], ok]


def _rows_select(torch, lib, shapes, tag, lo, hi):
    """Kernel 1 on rows of more than ``lo`` and at most ``hi`` bytes, all on
    the wide-row kernel: each shape against the plain version (random, the
    winner dead, ties), the score against row f's f64 score, and its time
    beside its bound and its library call.  Returns the largest score error."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    max_err = 0.0
    for name, n, S in shapes:
        dtype = getattr(torch, name)
        c, dirs = _select_problem(torch, n, S, dtype, seed=S)
        args = [c.Vsel, dirs, c.norms, c.valid]
        row_bytes = c.Vsel.shape[1] * c.Vsel.element_size()
        if not lo < row_bytes <= hi:
            raise AssertionError(f"{tag} {name} S={S}: a row of {row_bytes} bytes")
        scale = None if dtype == torch.int8 else (lambda a, f: _f32_scale(torch, a, f))
        label = f"{tag.replace('_', ' ')} {name} n={n} S={S}"
        before = gs.launches
        err = _hold_wide(torch, gs.giga_select, gs.giga_select_ref, args, _kill, label,
                         scale=scale)
        if gs.launches - before != 3:
            raise AssertionError(f"{label}: {gs.launches - before} launches for 3 selects")
        max_err = max(max_err, err)
        # the random case's scores against row f's f64 score: the kernel's
        # and the plain version's rounding apart
        ki, ks = gs.giga_select(*args)
        pi, pscore = gs.giga_select_ref(*args)
        s64, size = _f32_scale(torch, args, int(pi)) if scale else (float(pscore), 0.0)
        if abs(float(ks) - s64) > SELECT_TOL * abs(s64):
            raise AssertionError(f"{label}: kernel score {float(ks)} against {s64} in f64")
        f64 = dict(score_f64=f"{s64:.9e}", kernel_rel_err_f64=f"{abs(float(ks) - s64) / abs(s64):.3e}",
                   plain_rel_err_f64=f"{abs(float(pscore) - s64) / abs(s64):.3e}",
                   kernel_plain_rel=f"{abs(float(ks) - float(pscore)) / abs(float(pscore)):.3e}",
                   abs_scale=f"{size:.4e}")
        k_ms, bound_ms, bound_by = _time_select(torch, lib, args, S)
        p_ms = _median_ms(torch, lambda: gs.giga_select_ref(*args), batches=3, per_batch=3)
        lib_ms, lib_how = _library_ms(torch, c.Vsel, dirs)
        # every matrix here is far larger than L2: a batch of launches is as
        # cold as a single launch after a flush
        say(tag, dtype=name, n=n, S=S, row_bytes=row_bytes,
            kernel_ms=f"{k_ms:.4f}", cold_l2_ms="=kernel_ms(matrix>L2)",
            plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, share_of_bound=f"{bound_ms / k_ms:.3f}",
            library_dots_only_ms="not_run" if lib_ms is None else f"{lib_ms:.4f}",
            library=lib_how,
            kernel_GBps=f"{c.Vsel.numel() * c.Vsel.element_size() / (k_ms * 1e-3) / 1e9:.1f}",
            max_abs_err=err, **f64, checks="random,invalid_winner,ties")
        del c, args, dirs
        torch.cuda.empty_cache()
    return max_err


def _time_select(torch, lib, args, S):
    """Kernel 1's time on (Vsel, dirs, norms, valid) from a batch of direct
    launches, and its bound: (ms, bound_ms, bound_by)."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    Vsel, dirs, norms, valid = args
    ws, stream = gs.workspace(Vsel.device)
    idx = torch.empty(1, dtype=torch.int32, device=Vsel.device)
    score = torch.empty(1, dtype=torch.float32, device=Vsel.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    k_ms = _direct_ms(torch, lib.giga_select_launch, ptr(Vsel), gs._DTYPE_CODE[Vsel.dtype],
                      Vsel.shape[0], Vsel.shape[1] * Vsel.element_size(), ptr(dirs), S,
                      ptr(norms), ptr(valid), ptr(ws), ptr(idx), ptr(score),
                      ctypes.c_void_p(stream))
    return (k_ms, *_select_bound(torch, Vsel, S))


def _wide_select(torch, lib):
    """Kernel 1 on rows of 4-48 KB (``MID_SELECT``), then past 48 KB
    (``WIDE_SELECT``), through the wide-row kernel; then int8 dots past
    2^24."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    max_err = max(_rows_select(torch, lib, MID_SELECT, "select_mid", 4096, 48 * 1024),
                  _rows_select(torch, lib, WIDE_SELECT, "select_wide", 48 * 1024, 1 << 20))

    # int8 dots past 2^24: rows aligned with +-1 directions reach 49168 *
    # 127^2 = 7.9e8, where int32 -> f32 rounds (to nearest even, as the plain
    # version's f64 -> f32 does); the scores must be equal to the bit
    n, S = 300, 49168
    gen = torch.Generator(device="cuda").manual_seed(12)
    sign = torch.randint(0, 2, (S,), generator=gen, device="cuda") * 2 - 1
    V = torch.randint(-127, 128, (n, S), generator=gen, device="cuda", dtype=torch.int8)
    for r, keep in ((17, S), (101, S - 1), (250, S - 3)):
        V[r, :keep] = (127 * sign[:keep]).to(torch.int8)
    dirs = torch.stack([sign.float(), torch.zeros(S, device="cuda")], dim=1).contiguous()
    args = (V, dirs, torch.ones(n, device="cuda"), torch.ones(n, dtype=torch.bool, device="cuda"))
    (ki, ks), (pi, pscore) = gs.giga_select(*args), gs.giga_select_ref(*args)
    if (int(ki), float(ks)) != (int(pi), float(pscore)) or int(ki) != 17 \
            or not float(ks) * 127.0 ** 2 > 2.0 ** 24:
        raise AssertionError(f"int8 dots past 2^24: kernel ({int(ki)}, {float(ks)}), "
                             f"plain ({int(pi)}, {float(pscore)})")
    say("select_wide_int8_past_2^24", S=S, idx=int(ki), dot=f"{float(ks) * 127.0 ** 2:.0f}",
        score="identical")
    return max_err


def _wide_packed(torch, lib):
    """Kernel 2 on a packed row past the ring's shared memory."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps

    n, S = WIDE_N, WIDE_PACKED_S
    gen = torch.Generator(device="cuda").manual_seed(13)
    P = ps.pack_int4(torch.randint(-7, 8, (n, S), generator=gen, device="cuda",
                                   dtype=torch.int8))
    dirs = torch.rand((S, 2), generator=gen, device="cuda") * 0.08 - 0.04
    nrminv = 0.02 * (torch.rand(n, generator=gen, device="cuda") + 0.5)
    args = [P, dirs, nrminv, torch.zeros(n, device="cuda")]
    if P.shape[1] <= 32 * 1024:
        raise AssertionError(f"wide packed select: a row of {P.shape[1]} bytes")

    def kill(a, f):
        bias = a[3].clone()
        bias[f] = float("-inf")
        return [*a[:3], bias]

    before = ps.launches
    err = _hold_wide(torch, ps.packed_select, ps.packed_select_ref, args, kill,
                     f"wide packed select S={S}")
    if ps.launches - before != 3:
        raise AssertionError(f"wide packed select: {ps.launches - before} launches for 3 selects")
    ws, stream = gs.workspace(P.device)
    idx = torch.empty(1, dtype=torch.int32, device="cuda")
    score = torch.empty(1, dtype=torch.float32, device="cuda")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    k_ms = _direct_ms(torch, lib.packed_select_launch, ptr(P), n, P.shape[1], ptr(dirs), S,
                      ptr(nrminv), ptr(args[3]), ptr(ws), ptr(idx), ptr(score),
                      ctypes.c_void_p(stream))
    p_ms = _median_ms(torch, lambda: ps.packed_select_ref(*args), batches=3, per_batch=3)
    bound_ms, bound_by = _bound(P.numel() + 8 * n + S * 2 * 4 + 8, 4 * n * S, "int8")
    say("packed_select_wide", n=n, S=S, row_bytes=P.shape[1], kernel_ms=f"{k_ms:.4f}",
        cold_l2_ms="=kernel_ms(matrix>L2)", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / k_ms:.3f}",
        kernel_GBps=f"{P.numel() / (k_ms * 1e-3) / 1e9:.1f}", max_abs_err=err,
        checks="random,invalid_winner,ties")
    return err


def phase_select(torch):
    from bayesian_coresets_tpu_torch.ops import _cuda_build
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    lib = _cuda_build.load_library()
    codes = gs._DTYPE_CODE
    max_err, timing, graph = 0.0, {}, {}
    for dtype, n in [(torch.int8, N_MAIN), (torch.bfloat16, N_MAIN),
                     (torch.float32, N_MAIN), (torch.int8, 1_000_000)]:
        c, dirs = _select_problem(torch, n, S_MAIN, dtype, seed=n + codes[dtype])
        Vsel, norms, valid = c.Vsel, c.norms, c.valid

        def check(Vs, nr, ok, label, expect_idx=None, d=dirs):
            nonlocal max_err
            f, err = _hold(gs.giga_select, gs.giga_select_ref, (Vs, d, nr, ok),
                           f"select {dtype} n={n} {label}", expect_idx)
            max_err = max(max_err, err)
            return f

        f = check(Vsel, norms, valid, "random")
        checks = ["random", "invalid_block", "ties", "all_invalid"]
        if dtype == torch.int8:
            check(Vsel, norms, valid, "rounding_boundaries", d=_boundary_dirs(torch, S_MAIN, n))
            checks.append("rounding_boundaries")
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

        # device time: the kernel launched directly (no wrapper host work),
        # in a batch and cold; the plain version as the wrapper would run
        # it on a CPU tensor
        ws, stream = gs.workspace(Vsel.device)
        idx = torch.empty(1, dtype=torch.int32, device="cuda")
        score = torch.empty(1, dtype=torch.float32, device="cuda")
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        launch = (lib.giga_select_launch, ptr(Vsel), codes[dtype], n,
                  Vsel.shape[1] * Vsel.element_size(), ptr(dirs), S_MAIN, ptr(norms),
                  ptr(valid), ptr(ws), ptr(idx), ptr(score), ctypes.c_void_p(stream))
        k_ms = _direct_ms(torch, *launch)
        cold_ms = _cold_ms(torch, _launcher(*launch))
        # in a CUDA graph (20 launches, no host call between them), on a
        # stream and workspace of its own: the kernel's time without the
        # launch gap of direct calls
        graph_ws = torch.zeros(2, dtype=torch.int64, device="cuda")
        g_ms = _graph_ms(torch, lambda st: _launcher(launch[0], *launch[1:9], ptr(graph_ws),
                                                     *launch[10:12], ctypes.c_void_p(st)))
        graph[(dtype, n)] = (g_ms, Vsel.numel() * Vsel.element_size())
        w_ms = _median_ms(torch, lambda: gs.giga_select(Vsel, dirs, norms, valid))
        p_ms = _median_ms(torch, lambda: gs.giga_select_ref(Vsel, dirs, norms, valid),
                          batches=5, per_batch=5)
        bound_ms, bound_by = _select_bound(torch, Vsel, S_MAIN)
        lib_ms, lib_how = _library_ms(torch, Vsel, dirs)
        gbps = Vsel.numel() * Vsel.element_size() / (k_ms * 1e-3) / 1e9
        timing[(dtype, n)] = (k_ms, p_ms, bound_ms, bound_by, lib_ms)
        say("select", dtype=str(dtype).replace("torch.", ""), n=n, S=S_MAIN,
            kernel_ms=f"{k_ms:.4f}", graph_ms=f"{g_ms:.4f}", graph_share_of_bound=
            f"{bound_ms / g_ms:.3f}", cold_l2_ms=f"{cold_ms:.4f}", wrapper_ms=f"{w_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            share_of_bound=f"{bound_ms / k_ms:.3f}", cold_share=f"{bound_ms / cold_ms:.3f}",
            kernel_GBps=f"{gbps:.1f}",
            library_dots_only_ms="not_run" if lib_ms is None else f"{lib_ms:.4f}",
            library=lib_how, checks=",".join(checks))
        if not bound_ms / k_ms >= 0.5:
            raise AssertionError(f"select {dtype} n={n}: {k_ms} ms, under half of its "
                                 f"bound {bound_ms} ms")
        if (dtype, n) == (torch.int8, N_MAIN):
            empty_ms = _graph_ms(torch, lambda st: _launcher(
                lib.giga_empty_launch, ptr(Vsel), 1, n, ptr(norms), ptr(valid), ptr(graph_ws),
                ptr(idx), ptr(score), ctypes.c_void_p(st)))
        del c, Vsel, norms, valid, dirs
        torch.cuda.empty_cache()
    # kernel 1's fixed cost at int8: the in-graph time at N=100k less its
    # bytes at the rate the N=1M select reaches over the extra bytes
    (t1, b1), (t2, b2) = graph[(torch.int8, N_MAIN)], graph[(torch.int8, 1_000_000)]
    per_byte = (t2 - t1) / (b2 - b1)
    say("select_fixed_cost", dtype="int8", n=N_MAIN, batch_ms=f"{timing[(torch.int8, N_MAIN)][0]:.4f}",
        graph_ms=f"{t1:.4f}", graph_ms_N1M=f"{t2:.4f}", empty_kernel_graph_ms=f"{empty_ms:.4f}",
        marginal_GBps=f"{1e-6 / per_byte:.1f}", fixed_us=f"{1e3 * (t1 - per_byte * b1):.2f}",
        bound_ms=f"{timing[(torch.int8, N_MAIN)][2]:.4f}")
    max_err = max(max_err, _wide_select(torch, lib))
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
    _, err = _hold(ps.packed_select, ps.packed_select_ref,
                   (P, _boundary_dirs(torch, S, n), nrminv, bias),
                   "packed select rounding_boundaries")
    max_err = max(max_err, err)

    lib = _cuda_build.load_library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    ws, stream = gs.workspace(P.device)
    idx = torch.empty(1, dtype=torch.int32, device="cuda")
    score = torch.empty(1, dtype=torch.float32, device="cuda")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    tail = (ptr(ws), ptr(idx), ptr(score), ctypes.c_void_p(stream))
    packed = (lib.packed_select_launch, ptr(P), n, P.shape[1], ptr(dirs), S, ptr(nrminv),
              ptr(bias), *tail)
    int8 = (lib.giga_select_launch, ptr(V8), gs._DTYPE_CODE[torch.int8], n, S, ptr(dirs), S,
            ptr(nrminv), ptr(valid), *tail)
    k_ms, k_cold = _direct_ms(torch, *packed), _cold_ms(torch, _launcher(*packed))
    i8_ms, i8_cold = _direct_ms(torch, *int8), _cold_ms(torch, _launcher(*int8))
    p_ms = _median_ms(torch, lambda: ps.packed_select_ref(P, dirs, nrminv, bias),
                      batches=5, per_batch=3)
    # P, nrminv and bias read once, the f32 directions, (idx, score) out; a
    # multiply and an add per 4-bit value and direction
    bound_ms, bound_by = _bound(P.numel() + 8 * n + S * 2 * 4 + 8, 4 * n * S, "int8")
    i8_bound_ms, _ = _select_bound(torch, V8, S)
    i8_lib_ms, i8_lib_how = _library_ms(torch, V8, dirs)
    gb = lambda t, ms: t.numel() * t.element_size() / (ms * 1e-3) / 1e9  # noqa: E731
    say("packed_select", n=n, S=S, kernel_ms=f"{k_ms:.4f}", cold_l2_ms=f"{k_cold:.4f}",
        plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / k_ms:.3f}", cold_share=f"{bound_ms / k_cold:.3f}",
        kernel_GBps=f"{gb(P, k_ms):.1f}", max_abs_err=max_err,
        checks="random,invalid_block,ties,all_invalid,odd_rows,rounding_boundaries")
    say("int8_select_same_matrix", n=n, S=S, kernel_ms=f"{i8_ms:.4f}",
        cold_l2_ms=f"{i8_cold:.4f}", bound_ms=f"{i8_bound_ms:.4f}",
        share_of_bound=f"{i8_bound_ms / i8_ms:.3f}", cold_share=f"{i8_bound_ms / i8_cold:.3f}",
        kernel_GBps=f"{gb(V8, i8_ms):.1f}", packed_over_int8=f"{k_ms / i8_ms:.3f}",
        library_dots_only_ms="not_run" if i8_lib_ms is None else f"{i8_lib_ms:.4f}",
        library=i8_lib_how)
    for name, ms, bms in (("packed", k_ms, bound_ms), ("int8", i8_ms, i8_bound_ms)):
        if not bms / ms >= 0.5:
            raise AssertionError(f"{name} select at n={n}: {ms} ms, under half of its "
                                 f"bound {bms} ms")

    max_err = max(max_err, _wide_packed(torch, lib))

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
    return launches, max_err, k_ms, p_ms, bound_ms, bound_by


def phase_build_parity(torch):
    import numpy as np
    from bayesian_coresets_tpu_torch.coresets.projector import center_lls
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.parallel import quantize_chunk
    from bayesian_coresets_tpu_torch.utils import interop

    n, d, S, M = 20_000, 10, 500, 200
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-x @ np.full(d, 3.0))), 1.0, -1.0)
    z = (y[:, None] * x).astype(np.float32)
    th = (0.1 * rng.normal(size=(S, d))).astype(np.float32)
    vecs = center_lls(logistic.log_likelihood(torch.as_tensor(z), torch.as_tensor(th)))
    c_cpu = snnls.make_consts(vecs.T, vecs.sum(dim=0), select_dtype=torch.int8)
    # the same projection as int8-resident constants: quantize_chunk's rows
    # and norms, V itself int8, carried to the card as they are
    q, nrm, bsum = quantize_chunk(vecs, n)
    r_cpu = snnls.make_consts_quantized(q, nrm, bsum.float())
    for consts, mode in ((c_cpu, "int8_select"), (r_cpu, "int8_resident")):
        c_gpu = interop.snnls_consts(type(consts)(*(t.numpy() for t in consts)), "cuda")
        if mode == "int8_resident" and not (c_gpu.V.dtype == torch.int8 and c_gpu.Vsel is c_gpu.V):
            raise AssertionError("build parity: the int8-resident constants did not carry over")
        for method in ("giga", "frankwolfe"):
            _parity_build(torch, consts, c_gpu, method, mode, n, S, M)
    _wide_parity(torch)


def _wide_parity(torch):
    """A GIGA build through the wide-row kernel on the card against the same
    build through the plain version on the CPU: f32 select copy (V itself),
    rows of 49168 bytes.  The same atoms, or, where an f32 near-tie flips a
    select, both rows' plain scores at that select printed and the errors at
    M within 1e-3 relative."""
    import numpy as np
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import interop

    n, S, M = WIDE_PARITY_N, WIDE_PARITY_S, WIDE_PARITY_M
    rng = np.random.default_rng(9)
    A = rng.normal(size=(S, n)).astype(np.float32)
    c_cpu = snnls.make_consts(torch.as_tensor(A), torch.as_tensor(A[:, : n // 2].sum(axis=1)))
    c_gpu = interop.snnls_consts(type(c_cpu)(*(t.numpy() for t in c_cpu)), "cuda")
    row_bytes = c_gpu.Vsel.shape[1] * c_gpu.Vsel.element_size()
    if c_gpu.Vsel.dtype != torch.float32 or row_bytes <= 48 * 1024:
        raise AssertionError(f"wide parity: a {c_gpu.Vsel.dtype} row of {row_bytes} bytes")
    calls = {"cpu": [], "cuda": []}         # (dirs, selected row) per select
    # every GIGA select, the CPU's plain route and the card's fused one,
    # goes through giga_select_into
    select_into = gs.giga_select_into

    def recorded(Vsel, dirs, norms, valid, idx, score):
        select_into(Vsel, dirs, norms, valid, idx, score)
        calls["cuda" if Vsel is c_gpu.Vsel else "cpu"].append((dirs.cpu(), int(idx[0])))

    gs.giga_select_into = recorded
    try:
        s_cpu = snnls.build(c_cpu, snnls.init_state(c_cpu, 1024), M, 1e-6)
        before = gs.launches
        # one-iteration segments: the recorder reads each pick back, which
        # a captured graph cannot
        s_gpu = snnls.build(c_gpu, snnls.init_state(c_gpu, 1024), M, 1e-6, segment=1)
        torch.cuda.synchronize()
        launches = gs.launches - before
    finally:
        gs.giga_select_into = select_into
    if launches != int(s_gpu.itr) or int(s_gpu.itr) != M:
        raise AssertionError(f"wide parity: {launches} launches for {int(s_gpu.itr)} iterations")
    picks = [f for _, f in calls["cuda"]], [f for _, f in calls["cpu"]]
    e_gpu = float(snnls.error(c_gpu, s_gpu.w)) / float(c_gpu.bnorm)
    e_cpu = float(snnls.error(c_cpu, s_cpu.w)) / float(c_cpu.bnorm)
    if picks[0] == picks[1]:
        k = int(s_cpu.size)
        np.testing.assert_array_equal(s_gpu.idcs[:k].cpu().numpy(), s_cpu.idcs[:k].numpy())
        np.testing.assert_allclose(s_gpu.w.cpu().numpy(), s_cpu.w.numpy(), rtol=1e-4, atol=1e-6)
        say("build_parity", method="giga", consts="f32_wide", n=n, S=S, row_bytes=row_bytes,
            M=M, atoms=k, idcs="identical", err_cuda=f"{e_gpu:.6e}", err_cpu=f"{e_cpu:.6e}")
        return
    j = next(i for i, (a, b) in enumerate(zip(*picks)) if a != b)
    rows = [picks[0][j], picks[1][j]]
    q = gs.quantize_dirs(calls["cpu"][j][0], c_cpu.Vsel.shape[1], torch.float32)
    dots = (c_cpu.Vsel[rows] @ q.T) / c_cpu.norms[rows][:, None]
    sc = gs.score_rows(dots, torch.ones(2, dtype=torch.bool))
    say("build_parity_near_tie", consts="f32_wide", select=j, cuda_row=picks[0][j],
        cpu_row=picks[1][j], plain_score_cuda_row=f"{float(sc[0]):.9e}",
        plain_score_cpu_row=f"{float(sc[1]):.9e}", err_cuda=f"{e_gpu:.6e}",
        err_cpu=f"{e_cpu:.6e}")
    if not abs(e_gpu - e_cpu) <= 1e-3 * e_cpu:
        raise AssertionError(f"wide parity: errors at M {e_gpu} (card) and {e_cpu} (CPU)")


def _parity_build(torch, c_cpu, c_gpu, method, mode, n, S, M):
    """One build on the CPU (plain select) and on the card (the kernel) from
    the same constants: the same atoms, one launch per iteration."""
    import numpy as np
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls

    t0 = time.perf_counter()
    s_cpu = snnls.build(c_cpu, snnls.init_state(c_cpu, 1024), M, 1e-6, method=method)
    t_cpu = time.perf_counter() - t0
    before, ran = gs.launches, snnls.itrs_run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_gpu = snnls.build(c_gpu, snnls.init_state(c_gpu, 1024), M, 1e-6, method=method)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    k = int(s_cpu.size)
    ig, ic = s_gpu.idcs[:int(s_gpu.size)].cpu().numpy(), s_cpu.idcs[:k].numpy()
    if not np.array_equal(ig, ic):
        raise AssertionError(f"build parity ({method}, {mode}): card selected {ig[:20]}..., "
                             f"CPU {ic[:20]}...")
    _ran_check(f"build parity ({method}, {mode})", gs.launches - before,
               snnls.itrs_run - ran, int(s_gpu.itr), bool(s_gpu.done))
    np.testing.assert_allclose(s_gpu.w.cpu().numpy(), s_cpu.w.numpy(), rtol=1e-4, atol=1e-6)
    say("build_parity", method=method, consts=mode, n=n, S=S, M=M, atoms=k,
        itr=int(s_gpu.itr), idcs="identical", cuda_s=f"{t_gpu:.3f}", cpu_s=f"{t_cpu:.3f}")


def _near_map_sampler(gen, n, wts, pts):
    """bench.py's projection samples (bench.py:97): theta ~ 0.1 N(0, I)."""
    import torch
    return 0.1 * torch.randn((n, D_MAIN), generator=gen, device=gen.device)


def phase_main(torch, smi):
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()     # this path's own peak, not phase 3's
    t0 = time.perf_counter()
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), N_MAIN, D_MAIN)
    projector = bc.BlackBoxProjector(_near_map_sampler, S_MAIN, logistic.log_likelihood,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    gs.launches = fs.launches = snnls.itrs_run = 0
    _fused_reset()
    t0 = time.perf_counter()
    coreset = bc.HilbertCoreset(Z, projector, select_dtype=torch.int8, max_active=1024)
    torch.cuda.synchronize()
    t_proj = time.perf_counter() - t0
    bnorm = float(coreset.snnls.consts.bnorm)
    caps0, cap_s0 = _graph_counts()
    t0 = time.perf_counter()
    coreset.build(50)
    torch.cuda.synchronize()
    t_b1 = time.perf_counter() - t0
    s50 = coreset.snnls.state          # mid-build: the fused kernels' hold starts here
    err50 = coreset.error() / bnorm
    t0 = time.perf_counter()
    coreset.build(M_MAIN - 50)
    torch.cuda.synchronize()
    t_b2 = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    launches, fold_launches, ran = gs.launches, fs.launches, snnls.itrs_run
    itr = int(coreset.snnls.state.itr)
    err = coreset.error() / bnorm
    wts, pts, idcs = coreset.get()

    _ran_check("main path", launches, ran, itr, coreset.reached_numeric_limit)
    if fold_launches != ran:
        raise AssertionError(f"main path: {fold_launches} fold launches for {ran} iterations")
    fused_launches = _fused_count("main path", ran)
    if caps > MAIN_PIECES:
        raise AssertionError(f"main path: {caps} graphs captured, more than the {MAIN_PIECES} "
                             "pieces of a build of 50 and then 450")
    one_ms = _one_itr(torch, coreset.snnls.consts, "giga", (50, M_MAIN - 50),
                      coreset.snnls.state, 1024, "main path")
    atoms = int((coreset.snnls.weights() > 0).sum())
    if atoms != MAIN_ATOMS or f"{err:.6e}" != MAIN_ERR:
        raise AssertionError(f"main path: {atoms} atoms, error/|b| {err:.6e} at M={itr}; "
                             f"expected {MAIN_ATOMS} and {MAIN_ERR}")
    if wts.size == 0 or not np.isfinite(wts).all() or (wts <= 0).any():
        raise AssertionError("main path: empty or non-finite coreset")
    if pts.shape != (wts.size, D_MAIN) or not np.isfinite(pts).all():
        raise AssertionError("main path: coreset points malformed")
    if not err < err50:
        raise AssertionError(f"main path: error/|b| {err} at M={itr} not below {err50} at 50")
    t_build = t_b1 + t_b2
    say("main", N=N_MAIN, D=D_MAIN, S=S_MAIN, M=M_MAIN, itr=itr, size=wts.size,
        done=coreset.reached_numeric_limit, launches=launches, fold_launches=fold_launches,
        fused_step_launches=fused_launches, iterations_run=ran,
        err50=f"{err50:.6e}", err=f"{err:.6e}", graphs_captured=caps,
        capture_s=f"{cap_s:.4f}", one_itr_ms_per_itr=f"{one_ms:.4f}",
        one_itr_bit_identical=True, build_peak_mem_GB=f"{build_peak / 1e9:.3f}")
    prof = _profile_build(torch, coreset.snnls.consts, "giga", "main_launches")
    _profile_build(torch, coreset.snnls.consts, "giga", "main_launches", segment=1)
    fold = _hold_fold(torch, N_MAIN, "fold_kernel", smi)
    gstep = _hold_giga_step(torch, coreset.snnls.consts, s50, "giga_step_kernels", smi)
    ref6 = {"w": coreset.snnls.weights(), "itr": itr, "err": err, "idcs": idcs,
            "slots": _slots(coreset.snnls.state), "ms_per_itr": 1e3 * (t_b1 + t_b2) / itr,
            "fold_launches": fold_launches, "fold": fold[False], "giga_step": gstep, **prof}
    say("main_time", setup_s=f"{t_setup:.4f}", projection_s=f"{t_proj:.4f}",
        build_s=f"{t_build:.4f}", ms_per_itr=f"{1e3 * t_build / itr:.4f}",
        capture_s=f"{cap_s:.4f}", one_itr_ms_per_itr=f"{one_ms:.4f}",
        points_per_s=f"{M_MAIN / (t_proj + t_build):.2f}",
        peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}", card=repr(smi))
    rebuild = _main_rebuild(torch, smi, Z, coreset)
    return launches, wts, pts, coreset, Z, projector, ref6, rebuild


def _main_rebuild(torch, smi, Z, coreset):
    """Phase 6's build again on a fresh projection of the same shape (the
    projector's generator seeded 2, as bench.py's fresh keys), while the
    first coreset lives: its constants are copied into the static copies
    that the first build's graph sets read, and no graph is captured (the
    JAX package's one compilation per shape).  Its state is held bit for
    bit against its own one-iteration build.  Returns (the coreset, its
    select launches)."""
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import graphs, snnls

    dev = torch.device("cuda")
    projector = bc.BlackBoxProjector(_near_map_sampler, S_MAIN, logistic.log_likelihood,
                                     generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gs.launches = fs.launches = snnls.itrs_run = 0
    _fused_reset()
    caps0, cap_s0 = _graph_counts()
    loads0 = graphs.loads
    t0 = time.perf_counter()
    rebuilt = bc.HilbertCoreset(Z, projector, select_dtype=torch.int8, max_active=1024)
    torch.cuda.synchronize()
    t_proj = time.perf_counter() - t0
    bnorm = float(rebuilt.snnls.consts.bnorm)
    t0 = time.perf_counter()
    rebuilt.build(50)
    torch.cuda.synchronize()
    t_b1 = time.perf_counter() - t0
    err50 = rebuilt.error() / bnorm
    t0 = time.perf_counter()
    rebuilt.build(M_MAIN - 50)
    torch.cuda.synchronize()
    t_build = t_b1 + time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    launches, fold_launches, ran = gs.launches, fs.launches, snnls.itrs_run
    loads = graphs.loads - loads0
    itr = int(rebuilt.snnls.state.itr)
    _ran_check("main rebuild", launches, ran, itr, rebuilt.reached_numeric_limit)
    if fold_launches != ran:
        raise AssertionError(f"main rebuild: {fold_launches} fold launches for {ran} iterations")
    fused_launches = _fused_count("main rebuild", ran)
    if caps:
        raise AssertionError(f"main rebuild: {caps} graphs captured for constants of the first "
                             "build's shape")
    if loads < 1:
        raise AssertionError("main rebuild: its constants were never copied into the static "
                             "copies")
    one_ms = _one_itr(torch, rebuilt.snnls.consts, "giga", (50, M_MAIN - 50),
                      rebuilt.snnls.state, 1024, "main rebuild")
    copy = _copy_in(torch, coreset.snnls.consts, rebuilt.snnls.consts)
    err = rebuilt.error() / bnorm
    w1, w2 = coreset.snnls.weights(), rebuilt.snnls.weights()
    if not (np.isfinite(w2).all() and (w2 >= 0).all() and (w2 > 0).any()) or not err < err50:
        raise AssertionError(f"main rebuild: weights not finite and nonnegative, or error/|b| "
                             f"{err} at M={itr} not below {err50} at 50")
    if np.array_equal(w1, w2):
        raise AssertionError("main rebuild: the weights of the first build, on other data")
    say("main_rebuild", N=N_MAIN, S=S_MAIN, M=M_MAIN, itr=itr, launches=launches,
        fold_launches=fold_launches, fused_step_launches=fused_launches, iterations_run=ran, err50=f"{err50:.6e}",
        err=f"{err:.6e}", graphs_captured=caps, capture_s=f"{cap_s:.4f}", constants_copied=loads,
        copy_in_ms=f"{copy['ms']:.4f}", copy_in_MB=f"{copy['bytes'] / 1e6:.1f}",
        copy_in_bound_ms=f"{copy['bound_ms']:.4f}", projection_s=f"{t_proj:.4f}",
        build_s=f"{t_build:.4f}", ms_per_itr=f"{1e3 * t_build / itr:.4f}",
        points_per_s=f"{M_MAIN / (t_proj + t_build):.2f}", peak_mem_GB=f"{peak / 1e9:.3f}",
        one_itr_ms_per_itr=f"{one_ms:.4f}", one_itr_bit_identical=True, card=repr(smi))
    return rebuilt, launches


def _copy_in(torch, first, second, reps=10):
    """Copying constants into the static copies that the graph sets of
    their shape read (``ops/graphs.py::Statics.load``), timed with CUDA
    events, two constants in turn so that each load copies: the median ms,
    the bytes of the distinct tensors, and the bound of reading and writing
    them once each.  The second's are left in."""
    import numpy as np
    from bayesian_coresets_tpu_torch.ops import graphs

    st = graphs.statics_of(tuple(second))
    if st is None:
        raise AssertionError("main rebuild: no static copies for the constants' shape")
    times = []
    for i in range(2 * reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        copied = st.load(tuple(first if i % 2 == 0 else second))
        end.record()
        end.synchronize()
        if not copied:
            raise AssertionError("main rebuild: a load of other constants copied nothing")
        times.append(start.elapsed_time(end))
    nbytes = sum(t.numel() * t.element_size() for t in {id(t): t for t in st.tensors}.values())
    return {"ms": float(np.median(times)), "bytes": nbytes,
            "bound_ms": _bound(2 * nbytes, 0, "float32")[0]}


def _build_keys(st) -> int:
    """The graph keys of the build sets on the static copies ``st``."""
    return sum(len(e.graphs) for e in st.sets.values() if e.kind == "build")


def _main_regrid(torch, smi, Z):
    """Phase 6's build walked over a driver's log grid of sizes (the
    increments of ``coreset_size_grid(M_MAIN, 7, "log")``, as the drivers
    build) on fresh projections of phase 6's shape (generators seeded 3,
    then 4), after the first coreset and its rebuild are gone: their
    layout's static copies and sets are retired, and each walk revives
    them.  The first walk captures at most the pieces that the set lacks
    (SET_KEYS_MAX keys in all), the second none; each equals its
    one-iteration walk bit for bit."""
    import gc

    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.experiments.cli import coreset_size_grid
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import graphs, snnls

    dev = torch.device("cuda")
    Ms = coreset_size_grid(M_MAIN, 7, "log").tolist()
    steps = [Ms[0]] + [b - a for a, b in zip(Ms, Ms[1:])]
    launches = 0
    for walk, seed in enumerate((3, 4)):
        gc.collect()
        if not graphs._retired:
            raise AssertionError("main regrid: phase 6's layout was not retired with its "
                                 "last constants")
        retained = graphs.retained_bytes
        projector = bc.BlackBoxProjector(_near_map_sampler, S_MAIN, logistic.log_likelihood,
                                         generator=torch.Generator(device=dev).manual_seed(seed))
        coreset = bc.HilbertCoreset(Z, projector, select_dtype=torch.int8, max_active=1024)
        st = graphs.statics_of(tuple(coreset.snnls.consts))
        if st is None:
            raise AssertionError("main regrid: no retired static copies of phase 6's layout")
        held = _build_keys(st)
        gs.launches = fs.launches = snnls.itrs_run = 0
        _fused_reset()
        caps0, cap_s0 = _graph_counts()
        revivals = graphs.revivals
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, reads, sites = _count_syncs(torch, lambda: [coreset.build(k) for k in steps])
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
        walk_launches, ran, itr = gs.launches, snnls.itrs_run, int(coreset.snnls.state.itr)
        label = f"main regrid walk {walk + 1}"
        _ran_check(label, walk_launches, ran, itr, coreset.reached_numeric_limit)
        _fused_count(label, ran)
        launches += walk_launches
        if graphs.revivals != revivals + 1:
            raise AssertionError(f"{label}: the retired set was not revived")
        if caps > (SET_KEYS_MAX - held if walk == 0 else 0) or _build_keys(st) > SET_KEYS_MAX:
            raise AssertionError(f"{label}: {caps} graphs captured on a set that held {held} "
                                 f"keys (now {_build_keys(st)})")
        one_ms = _one_itr(torch, coreset.snnls.consts, "giga", steps, coreset.snnls.state, 1024,
                          label)
        err = coreset.error() / float(coreset.snnls.consts.bnorm)
        say("main_regrid", walk=walk + 1, seed=seed, sizes=",".join(str(m) for m in Ms),
            itr=itr, iterations_run=ran, launches=walk_launches, err=f"{err:.6e}",
            graphs_captured=caps, capture_s=f"{cap_s:.4f}", keys_before=held,
            keys_after=_build_keys(st), revivals=graphs.revivals - revivals,
            retained_bytes_before=retained, retained_bytes_after=graphs.retained_bytes,
            walk_s=f"{t:.4f}", ms_per_itr=f"{1e3 * t / itr:.4f}", host_reads=reads,
            read_sites=sites, one_itr_ms_per_itr=f"{one_ms:.4f}", one_itr_bit_identical=True,
            card=repr(smi))
        del coreset, projector, st
    gc.collect()
    return launches


def _slots(state):
    """The tracked atoms of a solver state, in the order they were first
    selected."""
    return state.idcs[:int(state.size)].cpu().numpy()


def _graph_counts():
    """(graphs captured, their capture plus instantiate seconds) so far."""
    from bayesian_coresets_tpu_torch.ops import graphs
    return graphs.captures, graphs.capture_s + graphs.instantiate_s


def _instantiate_s():
    from bayesian_coresets_tpu_torch.ops import graphs
    return graphs.instantiate_s


def _profile_build(torch, consts, method, tag, select_bound_ms=None, card=None, comm=None,
                   segment=None, max_active=1024, warm=65, window=PROFILE_ITRS):
    """Launches per iteration of ``method`` on phase 6's problem: ``warm``
    iterations of warm-up from a fresh state (and one window more, so that
    the window's graphs exist), then ``window`` under torch.profiler (one
    refresh inside), as scripts/profile_torch_build.py counts them; and the
    select kernel's share of the device time.  ``segment`` is passed to the
    build: by default it replays CUDA graphs (launches are their kernel
    nodes), ``segment=1`` runs one-iteration segments.  The build is
    functional: the coreset's own state is not touched.  With ``comm`` (one
    rank of a sharded build) the line also gives the NCCL kernels' device
    time per iteration.  Returns the line's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls

    def run(state, itrs):
        return snnls.build(consts, state, itrs, 1e-6, method=method, comm=comm,
                           matvec_k=max_active, segment=segment)

    caps0, cap_s0 = _graph_counts()
    inst0 = _instantiate_s()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = run(snnls.init_state(consts, max_active), warm)
    if segment != 1 and comm is None:
        run(s, window)                       # captures the window's graphs
    torch.cuda.synchronize()
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    inst_s = _instantiate_s() - inst0
    t0 = time.perf_counter()
    run(s, window)                                                   # unprofiled
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / window
    # One profiled window (phase 17's, late in a full run) came back with 61
    # select kernels for 64 launches, at half the time CUDA events give each;
    # the same window profiled in a fresh process had all 64 at full length.
    # A short window is profiled again, at most twice, and the line says how
    # many were short.
    for short in range(3):
        before = gs.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s2 = run(s, window)
            torch.cuda.synchronize()
        itrs = int(s2.itr) - int(s.itr)
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if itrs != window or not rows:
            raise AssertionError(f"{tag}: {itrs} iterations, {len(rows)} kernel rows")
        select = sum(e.count for e in rows if "giga_select" in e.key)
        if select == itrs or gs.launches - before != itrs:
            break
        print(f"[{tag}_short_window] select_kernels={select} wrapper_launches="
              f"{gs.launches - before} itrs={itrs}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    total = sum(e.count for e in rows)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    select_us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows
                    if "giga_select" in e.key)
    nccl_us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows
                  if "nccl" in e.key.lower())
    path = "one_itr" if segment == 1 or comm is not None else "graphs"
    stats = {"launches_per_itr": total / itrs, "device_busy_us_per_itr": busy_us / itrs,
             "unprofiled_wall_ms_per_itr": wall_ms, "nccl_us_per_itr": nccl_us / itrs,
             "select_launches_per_itr": select / itrs, "idle_share": 1.0 - busy_us * 1e-3
             / itrs / wall_ms, "captures": caps, "capture_s": cap_s, "peak_GB": peak / 1e9}
    say(tag, method=method, path=path, window_itrs=itrs, short_windows=short,
        select_launches_per_itr=f"{select / itrs:.3f}",
        wrapper_launches_per_itr=f"{(gs.launches - before) / itrs:.3f}",
        launches_per_itr=f"{total / itrs:.2f}", device_busy_us_per_itr=f"{busy_us / itrs:.1f}",
        unprofiled_wall_ms_per_itr=f"{wall_ms:.4f}",
        idle_share=f"{stats['idle_share']:.4f}",
        select_us_per_itr=f"{select_us / itrs:.1f}",
        **({} if comm is None else {"nccl_us_per_itr": f"{nccl_us / itrs:.1f}"}),
        select_share_of_device=f"{select_us / busy_us:.3f}" if busy_us else "not_measured",
        graphs_captured=caps, capture_s=f"{cap_s:.4f}", instantiate_s=f"{inst_s:.4f}",
        peak_mem_GB=f"{peak / 1e9:.3f}",
        **({} if select_bound_ms is None else {
            "select_bound_us": f"{1e3 * select_bound_ms:.1f}",
            "select_share_of_bound": f"{1e3 * select_bound_ms * itrs / select_us:.3f}"
            if select_us else "not_measured", "card": repr(card)}))
    expect = 0 if method in ("importance", "uniform") else itrs
    if select != expect or gs.launches - before != expect:
        raise AssertionError(f"{tag}: {select} select kernels on the card and "
                             f"{gs.launches - before} wrapper launches for {itrs} iterations")
    return stats


def _hold_fold(torch, n, tag, smi):
    """The gated fold kernel (``csrc/fold_scale.cu``) against its plain
    version on an (n,) weight vector, with the flag set (a fold by 3e-11,
    as a first iteration's) and clear: the weights bit for bit.  Then each
    timed: direct launches (batch), 20 launches in a CUDA graph, and the
    plain version, beside the bound of what the call must move (the flag
    and the scale, and with the flag set the n weights read and written).
    Returns {flag: times}."""
    from bayesian_coresets_tpu_torch.ops import _cuda_build
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs

    lib = _cuda_build.load_library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    w0 = 3.0 * torch.rand(n, generator=torch.Generator(device="cuda").manual_seed(n),
                          device="cuda")
    fold, keep = torch.full((), 3e-11, device="cuda"), torch.full((), 0.9999999, device="cuda")
    out = {}
    for flag in (True, False):
        f = torch.full((), flag, dtype=torch.bool, device="cuda")
        wk, wp = w0.clone(), w0.clone()
        before = fs.launches
        fs.fold_scale(wk, f, fold)
        fs.fold_scale_ref(wp, f, fold)
        torch.cuda.synchronize()
        if fs.launches != before + 1 or not torch.equal(wk.view(torch.int32),
                                                       wp.view(torch.int32)):
            raise AssertionError(f"fold kernel n={n} flag={flag}: not the plain version's "
                                 "weights bit for bit")
        fs.launches = before
        # timed with a scale near 1, so that repeated folds keep the weights normal
        k_ms = _direct_ms(torch, lib.fold_scale_launch, ptr(wk), n, ptr(f), ptr(keep),
                          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        g_ms = _graph_ms(torch, lambda st: _launcher(lib.fold_scale_launch, ptr(wk), n, ptr(f),
                                                     ptr(keep), ctypes.c_void_p(st)))
        p_ms = _median_ms(torch, lambda: fs.fold_scale_ref(wp, f, keep))
        b_ms, b_by = _bound(1 + 4 + (8 * n if flag else 0), n if flag else 0, "float32")
        out[flag] = dict(ms=k_ms, graph_ms=g_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        say(tag, n=n, flag=flag, kernel_ms=f"{k_ms:.4f}", graph_ms=f"{g_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by,
            share_of_bound=f"{b_ms / k_ms:.3f}", graph_share_of_bound=f"{b_ms / g_ms:.3f}",
            weights="bit_identical", card=repr(smi))
    return out


def _hold_giga_step(torch, consts, state, tag, smi, itrs=GIGA_STEP_HOLD_ITRS):
    """The fused GIGA step's two kernels (``csrc/giga_step.cu``) against
    their plain versions on the card, from a build's ``state`` on its
    constants: ``itrs`` iterations in lockstep from two copies of its
    carry, each kernel's output held bit for bit to its plain version's on
    the same inputs (the directions; after the kernel's select, copied to
    the plain side, the whole carry and the step's work; after the fold,
    the weights and the next directions).  Then each timed: direct launches
    (batch), 20 launches in a CUDA graph, and the plain version, beside the
    bound of the bytes it moves.  The kernels' counters are left as they
    were.  Returns {"update": times, "dirs": times}, the directions kernel
    timed as it runs once an iteration, with the weight write (``finish``)."""
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import giga_step as gst
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import config

    counts = gs.launches, fs.launches, gst.launches, gst.dirs_launches
    tol = config.TOL
    carry = snnls._carry(consts, state, int(state.itr) + 10**6)
    ck, cp = (type(carry)(*(t.clone() for t in carry)) for _ in range(2))
    step = gst.Step(consts, ck, tol)                     # the directions kernel
    wk, wp = step.work, gst.work(cp.xw)
    gst.directions_ref(consts, cp, wp)

    def hold(what, names, a, b):
        for name in names:
            if not _same_bits(torch, getattr(a, name), getattr(b, name)):
                raise AssertionError(f"{tag}: the {what} kernel's {name} is not its plain "
                                     "version's bit for bit")

    hold("directions", ("dirs",), wk, wp)
    commits = 0
    for _ in range(itrs):
        gs.giga_select_into(consts.Vsel, wk.dirs, consts.norms, consts.valid, wk.f, wk.score)
        wp.f.copy_(wk.f)
        wp.score.copy_(wk.score)
        step.update()
        gst.update_ref(consts, cp, tol, wp)
        hold("update", snnls._Carry._fields, ck, cp)
        hold("update", ("commit", "fold", "ws2", "raw"), wk, wp)
        commits += int(wk.commit)
        fs.fold_scale(ck.w, wk.fold, wk.ws2)
        fs.fold_scale(cp.w, wp.fold, wp.ws2)
        step.finish()
        gst.finish_ref(consts, cp, wp)
        hold("finish", ("w",), ck, cp)
        hold("finish", ("dirs",), wk, wp)
    torch.cuda.synchronize()
    lib = step.lib
    S, K = ck.xw.shape[0], ck.idcs.shape[0]
    row_bytes = consts.V.shape[1] * consts.V.element_size()
    # update: b and xw read, xw written, the row (and its norm), the slots;
    # two dots of the row, the axpy and three dots of the new xw. dirs:
    # b and xw read, the (S, 2) directions written, one weight written
    bounds = {"update": _bound(12 * S + row_bytes + 4 + 4 * K, 13 * S, "float32"),
              "dirs": _bound(16 * S + 4, 5 * S, "float32")}
    args = {"update": (lib.giga_step_update_launch, step._update),
            "dirs": (lib.giga_step_dirs_launch, step._finish)}
    plain = {"update": lambda: gst.update_ref(consts, cp, tol, wp),
             "dirs": lambda: gst.finish_ref(consts, cp, wp)}
    out = {}
    for name, (fn, a) in args.items():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        k_ms = _direct_ms(torch, fn, *a, stream)
        g_ms = _graph_ms(torch, lambda st, fn=fn, a=a: _launcher(fn, *a, ctypes.c_void_p(st)))
        p_ms = _median_ms(torch, plain[name])
        b_ms, b_by = bounds[name]
        out[name] = dict(ms=k_ms, graph_ms=g_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        say(tag, kernel=name, n=consts.V.shape[0], S=S, K=K, V=str(consts.V.dtype),
            itr=int(state.itr), itrs_held=itrs, commits=commits, kernel_ms=f"{k_ms:.4f}",
            graph_ms=f"{g_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{b_ms:.3e}",
            bound_by=b_by, graph_share_of_bound=f"{b_ms / g_ms:.3e}",
            outputs="bit_identical", card=repr(smi))
    gs.launches, fs.launches, gst.launches, gst.dirs_launches = counts
    return out


def _fused_reset():
    from bayesian_coresets_tpu_torch.ops import giga_step as gst
    gst.launches = gst.dirs_launches = 0


def _fused_count(label, expect):
    """The fused GIGA step's launches since :func:`_fused_reset`: the update
    kernel once per GIGA iteration run (``expect``), the directions kernel
    once per iteration and once per segment piece, and neither on any other
    route (``expect`` 0).  Adds them to FUSED_LAUNCHES, sets the counters
    to 0 and returns the update kernel's."""
    from bayesian_coresets_tpu_torch.ops import giga_step as gst
    up, dirs = gst.launches, gst.dirs_launches
    if up != expect or (dirs - up <= 0 if up else dirs != 0) or dirs > 2 * up:
        raise AssertionError(f"{label}: {up} fused step and {dirs} directions launches for "
                             f"{expect} GIGA iterations run")
    FUSED_LAUNCHES["update"] += up
    FUSED_LAUNCHES["dirs"] += dirs
    _fused_reset()
    return up


def _one_itr(torch, consts, method, steps, ref_state, max_active, label):
    """The build of ``steps`` (the calls' iteration counts) on the same
    constants in one-iteration segments: its state must be the replayed
    build's (``ref_state``) bit for bit.  Returns its ms per iteration."""
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import config

    s, t = snnls.init_state(consts, max_active), 0.0
    for k in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = snnls.build(consts, s, k, config.TOL, method=method, matvec_k=max_active,
                        segment=1)
        torch.cuda.synchronize()
        t += time.perf_counter() - t0
    for name in snnls.SNNLSState._fields:
        x, y = getattr(s, name), getattr(ref_state, name)
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{label}: the replayed build's {name} differs from the "
                                 "one-iteration segments'")
    return 1e3 * t / max(int(s.itr), 1)


def _ran_check(label, launches, ran, itrs, done, length=64):
    """The select launched once per iteration the build loop ran
    (``snnls.itrs_run``, replays counted): the iterations the state
    advanced, and only after ``done`` latched inside a segment up to that
    segment's rest more (gated iterations still select)."""
    extra = ran - itrs
    if launches != ran or itrs == 0 or extra < 0 or (extra and not done) or extra >= length:
        raise AssertionError(f"{label}: {launches} select launches, {ran} iterations run, "
                             f"{itrs} advanced, done={done}")


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
    caps0, cap_s0 = _graph_counts()
    inst0 = _instantiate_s()
    _, t, res = weighted.run(logistic, zc, wc, NUTS_DRAWS,
                             torch.Generator(device=dev).manual_seed(5),
                             num_chains=NUTS_CHAINS, target_accept=0.8, num_warmup=NUTS_DRAWS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9     # the sampler's own
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    inst_s = _instantiate_s() - inst0
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
        ms_per_transition=f"{1e3 * t / transitions:.3f}", path="graphs",
        segment=nuts.SEGMENT, graphs_captured=caps, capture_s=f"{cap_s:.4f}",
        instantiate_s=f"{inst_s:.4f}", peak_mem_GB=f"{peak_gb:.3f}", card=repr(smi))
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
    _nuts_parity(torch, smi, zc, wc)
    _nuts_windows(torch, smi, zc, wc, res)


def _same_bits(torch, a, b) -> bool:
    """Two nested results equal bit for bit."""
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.is_floating_point():
            kind = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.contiguous().view(kind), b.contiguous().view(kind)
        return bool(torch.equal(a, b))
    return all(_same_bits(torch, x, y) for x, y in zip(a, b, strict=True))


def _nuts_parity(torch, smi, zc, wc):
    """The phase's sampler at 1024 chains x (NUTS_SHORT + NUTS_SHORT), replayed
    and direct (``graphs=False``) from one seed: samples and every field of
    the result bit for bit, and the generator left at the same place."""
    from bayesian_coresets_tpu_torch.mcmc import nuts, weighted
    from bayesian_coresets_tpu_torch.models import logistic

    out = []
    for graphs in (None, False):
        gen = torch.Generator(device=zc.device).manual_seed(7)
        reads, leaves = nuts.host_reads, nuts.leaf_steps
        _, t, r = weighted.run(logistic, zc, wc, NUTS_SHORT, gen, num_chains=NUTS_CHAINS,
                               target_accept=0.8, num_warmup=NUTS_SHORT, graphs=graphs)
        n = 2 * NUTS_SHORT
        out.append((r, gen.get_state(), t, (nuts.host_reads - reads) / n,
                    (nuts.leaf_steps - leaves) / n))
    same = _same_bits(torch, out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    say("nuts_parity", chains=NUTS_CHAINS, warmup=NUTS_SHORT, draws=NUTS_SHORT,
        same_bits=same, graphs_s=f"{out[0][2]:.3f}", direct_s=f"{out[1][2]:.3f}",
        graphs_reads_per_transition=f"{out[0][3]:.2f}",
        direct_reads_per_transition=f"{out[1][3]:.2f}",
        leaves_per_transition=f"{out[0][4]:.2f}", card=repr(smi))
    if not same:
        raise AssertionError("nuts: the replayed run differs from the direct one")


def _load_script(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nuts_windows(torch, smi, zc, wc, res):
    """A window of NUTS_WINDOW transitions from the run's last draws with its
    adapted step sizes and metrics, direct and replayed, as
    scripts/profile_torch_nuts.py measures them (the first window makes the
    graphs, the second is timed, the third repeats it under the profiler):
    one line each, and the kernels that take the most device time; the
    states after them must agree bit for bit."""
    from bayesian_coresets_tpu_torch.models import logistic

    prof = _load_script("profile_torch_nuts")
    vg, state, step, inv_mass = prof.u_space(torch, logistic, zc, wc, zc.shape[1], res)
    ref, ref_state = prof.window_stats(torch, vg, state, step, inv_mass, NUTS_WINDOW)
    rep, rep_state = prof.window_stats(torch, vg, state, step, inv_mass, NUTS_WINDOW,
                                       graphs=True)
    same = prof.same_state(torch, rep_state, ref_state)
    for s in (ref, rep):
        say("nuts_window", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                              for k, v in s.items() if k != "top_kernels"},
            window=NUTS_WINDOW, same_bits=same, card=repr(smi))
        for name, us, calls in s["top_kernels"][:5]:
            print(f"    {s['path']}: {us:.1f} us and {calls:.1f} calls a transition: {name}")
    if not same:
        raise AssertionError("nuts: the replayed window differs from the direct one")
    for key in ("device_busy_ms_per_transition", "idle_share"):
        if rep[key] is None:
            raise AssertionError(f"nuts: the profiler recorded no device time ({key})")


def _pad(act) -> int:
    """The padded size ``SparseNNLS.optimize`` solves an active set at."""
    import numpy as np
    return 1 << max(3, int(np.ceil(np.log2(act.size))))


def phase_optimize(torch, coreset, rebuilt):
    """HilbertCoreset.optimize() (FISTA on the card), then the exact host
    solver on the same active set; then optimize() on phase 6's rebuild,
    which replays the graph of the first's padded size where it has the
    same one."""
    import numpy as np
    from bayesian_coresets_tpu_torch import native
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import config

    bnorm = float(coreset.snnls.consts.bnorm)
    e0 = coreset.error() / bnorm
    size0 = coreset.size()
    st0, act = coreset.snnls.state, np.sort(coreset.snnls.active()[0])   # as optimize() does
    caps0, cap_s0 = _graph_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coreset.optimize()
    torch.cuda.synchronize()
    t_fista = time.perf_counter() - t0
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    # the same solve from the same state again: a replay of its graph
    idcs = np.zeros(_pad(act), dtype=np.int32)
    idcs[:act.size] = act
    idcs = torch.as_tensor(idcs, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snnls.optimize_active(coreset.snnls.consts, st0, idcs, act.size, config.TOL)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    if _graph_counts()[0] != caps0 + caps:
        raise AssertionError("optimize: the second solve of one padded size captured again")
    e1 = coreset.error() / bnorm
    if coreset.reached_numeric_limit or not e1 <= e0 * (1.0 + 1e-6):
        raise AssertionError(f"optimize: error/|b| {e0} -> {e1}, "
                             f"latched={coreset.reached_numeric_limit}")
    t0 = time.perf_counter()
    native.load_library()                       # g++ of nnls.cpp, at first use
    t_gxx = time.perf_counter() - t0
    sn = coreset.snnls
    t0 = time.perf_counter()
    sn.optimize(solver="exact")
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    e2 = sn.error() / bnorm
    if sn.reached_numeric_limit or not e2 <= e1 * (1.0 + 1e-3):
        raise AssertionError(f"optimize: exact error/|b| {e2} against FISTA's {e1}, "
                             f"latched={sn.reached_numeric_limit}")
    say("optimize", atoms_before=size0, err_before=f"{e0:.6e}", fista_err=f"{e1:.6e}",
        fista_atoms=coreset.size(), fista_s=f"{t_fista:.4f}", graphs_captured=caps,
        capture_s=f"{cap_s:.4f}", fista_replay_s=f"{t_replay:.4f}", exact_err=f"{e2:.6e}",
        exact_atoms=sn.size(), exact_s=f"{t_exact:.4f}", gxx_build_s=f"{t_gxx:.3f}")
    _optimize_rebuild(torch, rebuilt, _pad(act))


def _optimize_rebuild(torch, rebuilt, first_pad):
    """optimize() on phase 6's rebuild: no capture where its padded size is
    the first coreset's, and the weights of the same solve run uncaptured
    on its own constants bit for bit."""
    import numpy as np
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import config

    sn = rebuilt.snnls
    bnorm = float(sn.consts.bnorm)
    e0, st0, act = sn.error() / bnorm, sn.state, np.sort(sn.active()[0])
    idcs = np.zeros(_pad(act), dtype=np.int32)
    idcs[:act.size] = act
    idcs = torch.as_tensor(idcs, device="cuda")
    caps0, cap_s0 = _graph_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rebuilt.optimize()
    torch.cuda.synchronize()
    t_fista = time.perf_counter() - t0
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    w, _, done, _ = snnls._optimize_core(sn.consts, st0.w, st0.xw, st0.done, idcs, act.size,
                                         config.TOL, 512)
    e1 = sn.error() / bnorm
    if caps != (0 if _pad(act) == first_pad else 1):
        raise AssertionError(f"optimize rebuild: {caps} graphs captured at padded size "
                             f"{_pad(act)} (the first coreset's {first_pad})")
    if not torch.equal(sn.state.w.view(torch.int32), w.view(torch.int32)) \
            or bool(sn.state.done) != bool(done):
        raise AssertionError("optimize rebuild: the replayed solve's weights differ from the "
                             "same solve run uncaptured")
    if sn.reached_numeric_limit or not e1 <= e0 * (1.0 + 1e-6):
        raise AssertionError(f"optimize rebuild: error/|b| {e0} -> {e1}, "
                             f"latched={sn.reached_numeric_limit}")
    say("optimize_rebuild", atoms_before=act.size, pad=_pad(act), first_pad=first_pad,
        err_before=f"{e0:.6e}", fista_err=f"{e1:.6e}", fista_s=f"{t_fista:.4f}",
        graphs_captured=caps, capture_s=f"{cap_s:.4f}", uncaptured_bit_identical=True)


def _gaussian_data(torch, N, d, dev):
    """bench.py's gaussian data on ``dev``: x_i = 1 + N(0, I)."""
    from bayesian_coresets_tpu_torch.models import gaussian
    return gaussian.gen_synthetic(torch.Generator(device=dev).manual_seed(1), N, d)


def _gaussian_family(torch, d, dev, S=None, grad=False, basis=None):
    """bench.py's gaussian model on ``dev`` (identity prior and likelihood
    precision): the black-box family over the posterior basis sampler with
    ``S`` samples, or the exact family (``S=None``)."""
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import gaussian

    mu0, eye = torch.zeros(d, device=dev), torch.eye(d, device=dev)
    if basis is None:
        basis = gaussian.posterior_basis(mu0, eye, eye)
    if S is None:
        return bc.gaussian_tangent_family(mu0, eye, eye, eye, basis=basis)

    def sampler(g, n, w, p):
        if p.numel() == 0:                      # projector-construction probe
            w, p = torch.zeros(1, device=dev), torch.zeros((1, d), device=dev)
        return gaussian.sample_weighted_post_basis(g, basis, p, w, n)

    gll = (lambda p, th: gaussian.grad_x_log_likelihood(p, th, eye)) if grad else None
    return bc.coresets.blackbox_family(
        sampler, S, lambda p, th: gaussian.log_likelihood(p, th, eye, 0.0), gll)


def _rkl64(x, w, p):
    """rKL of the weighted coreset posterior against the full-data one, in
    f64 on the host, closed form for the identity prior and likelihood."""
    import numpy as np
    from bayesian_coresets_tpu_torch.models import gaussian

    x, w = np.asarray(x, np.float64), np.asarray(w, np.float64)
    p = np.atleast_2d(np.asarray(p, np.float64))
    n, d = x.shape
    sw = w.sum()
    return gaussian.kl_divergence_np((w[:, None] * p).sum(0) / (1 + sw), np.eye(d) / (1 + sw),
                                     x.sum(0) / (1 + n), (1 + n) * np.eye(d))


def _count_syncs(torch, fn):
    """Run ``fn`` with CUDA's sync debug mode on; returns (result, the number
    of synchronizing calls it made, i.e. its device-to-host reads, and
    where they were made: ``file:line*count`` joined by commas)."""
    import collections
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                if "called a synchronizing CUDA operation" in str(w.message))
    return out, sum(sites.values()), ",".join(f"{k}*{v}" for k, v in sites.items()) or "none"


def _profile_window(torch, fn, steps):
    """Kernel launches and device-busy µs per step, and the idle share, of
    ``fn`` (``steps`` Adam steps) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    launches = sum(e.count for e in rows)
    if not rows:
        return "not_measured", "not_measured", "not_measured"
    return (f"{launches / steps:.1f}", f"{busy / steps:.1f}",
            f"{1.0 - busy * 1e-6 / wall:.4f}")


def _adam_window(torch, fn, steps):
    """A window of ``steps`` Adam steps (``fn()``), replayed or direct: run
    twice first (for graphs, the warm-up and the capture), then timed and
    profiled: (wall µs, kernels or graph nodes, device-busy µs per step,
    idle share)."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, busy_us, idle = _profile_window(torch, fn, steps)
    return f"{1e6 * wall / steps:.2f}", launches, busy_us, idle


def _replayed_and_direct(torch, tag, run, steps, window, states):
    """The same build replayed (``graphs=None``) and direct
    (``graphs=False``), each after a warm-up build of its own (the
    replayed one captures): seconds, host reads and where, graphs captured
    and their capture and instantiate seconds; the results and the
    generator's state after (``states(out)``) must agree bit for bit.
    Then ``window(graphs)``'s replayed and direct windows.  Returns
    (replayed output, the line's numbers)."""
    out, kv = {}, {}
    for graphs, path in ((None, "replayed"), (False, "direct")):
        caps0, cap0, inst0 = _graph_counts() + (_instantiate_s(),)
        run(2, graphs)                                      # warm-up (captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, syncs, sites = _count_syncs(torch, lambda: run(3, graphs))
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap0)))
        out[path] = res
        us, nodes, busy, idle = _adam_window(torch, lambda: window(graphs), PROFILE_STEPS)
        kv.update({f"{path}_s": f"{t:.4f}", f"{path}_us_per_adam_step": f"{1e6 * t / steps:.2f}",
                   f"{path}_host_reads": syncs, f"{path}_read_sites": sites,
                   f"{path}_window_us_per_step": us, f"{path}_nodes_per_step": nodes,
                   f"{path}_busy_us_per_step": busy, f"{path}_idle_share": idle,
                   f"{path}_graphs_captured": caps, f"{path}_capture_s": f"{cap_s:.4f}",
                   f"{path}_instantiate_s": f"{_instantiate_s() - inst0:.4f}"})
    a, b = states(out["replayed"]), states(out["direct"])
    if not all(_same_bits(torch, x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{tag}: the replayed Adam steps differ from the direct ones")
    return out["replayed"], kv


def _svi_arm(torch, smi, tag, N, n_sub, blackbox):
    import numpy as np
    from bayesian_coresets_tpu_torch.coresets import sparsevi
    from bayesian_coresets_tpu_torch.ops import opt

    dev = torch.device("cuda")
    x = _gaussian_data(torch, N, SVI_D, dev)
    fam = _gaussian_family(torch, SVI_D, dev, SVI_S if blackbox else None)
    sched = lambda i: 1.0 / (1.0 + i)   # noqa: E731
    gen = torch.Generator(device=dev)   # one per run: the graphs are kept per generator

    def run(seed, graphs):
        w0 = torch.zeros(SVI_CAP, device=dev)
        i0 = torch.full((SVI_CAP,), -1, dtype=torch.int64, device=dev)
        w, idcs, size = sparsevi.svi_build(
            x, w0, i0, 0, gen.manual_seed(seed), SVI_M, family=fam, n_sub_sel=n_sub,
            n_sub_opt=n_sub, opt_itrs=SVI_OPT, step_sched=sched, graphs=graphs)
        return w, idcs, size, sparsevi._gather_pts(x, idcs), gen.get_state()

    built = {}

    def window(graphs):                 # an optimize of the built coreset
        w, idcs, size, pts, _ = built["out"]
        carry = sparsevi._init_carry(x, fam, w, pts, size)
        return sparsevi._optimize(x, fam, gen.manual_seed(4), w, pts, size, n_sub,
                                  PROFILE_STEPS, sched, carry, graphs=graphs)

    built["out"] = run(1, False)
    (w, idcs, size, _, _), kv = _replayed_and_direct(
        torch, f"svi {tag}", run, SVI_M * SVI_OPT, window,
        lambda o: (o[0], o[1], o[3], o[4], torch.tensor([o[2]])))
    t = float(kv["replayed_s"])
    wn, ix = w[:size].cpu().numpy(), idcs[:size].cpu().numpy()
    xh = x.cpu().numpy()
    rkl = _rkl64(xh, wn, xh[ix])
    say("svi", arm=tag, N=N, d=SVI_D, S=SVI_S if blackbox else SVI_D + 1, M=SVI_M,
        opt_itrs=SVI_OPT, n_sub=n_sub, size=size, build_s=f"{t:.4f}",
        points_per_s=f"{SVI_M / t:.2f}", segment=opt.SEGMENT, replayed_equals_direct="yes",
        **kv, rkl=f"{rkl:.4f}", jax_cpu_rkl_max=JAX_RKL_MAX[tag], card=repr(smi))
    if not (np.isfinite(wn).all() and (wn >= 0).all()):
        raise AssertionError(f"svi {tag}: weights not finite and nonnegative: {wn}")
    if size > SVI_M or len(set(ix.tolist())) != size or size == 0:
        raise AssertionError(f"svi {tag}: {size} slots with indices {ix}")
    for path in ("replayed", "direct"):     # one flag per select, none per Adam step
        if kv[f"{path}_host_reads"] != SVI_M:
            raise AssertionError(f"svi {tag}: {kv[f'{path}_host_reads']} host reads in a "
                                 f"{path} build of {SVI_M} selects "
                                 f"({kv[f'{path}_read_sites']})")
    if not rkl <= RKL_SLACK * JAX_RKL_MAX[tag]:
        raise AssertionError(f"svi {tag}: rKL {rkl} above {RKL_SLACK} x the JAX "
                             f"package's {JAX_RKL_MAX[tag]}")
    return t


def phase_svi(torch, smi):
    _svi_arm(torch, smi, "canonical_blackbox", SVI_N, None, True)
    _svi_arm(torch, smi, "canonical_exact", SVI_N, None, False)
    _svi_arm(torch, smi, "scaled_N100k_sub1024", SVI_N_SCALED, SVI_SUB_SCALED, True)


def phase_svi_parity(torch):
    """The exact-family build on the card and on the CPU from the same data
    and the same posterior basis (the identity has no unique eigenbasis)."""
    import numpy as np
    from bayesian_coresets_tpu_torch.coresets import sparsevi
    from bayesian_coresets_tpu_torch.models import gaussian

    cpu = torch.device("cpu")
    eye = torch.eye(SVI_D)
    basis = gaussian.posterior_basis(torch.zeros(SVI_D), eye, eye)
    x_cpu = _gaussian_data(torch, SVI_N, SVI_D, cpu)
    out, secs = {}, {}
    for label, dev in (("cuda", torch.device("cuda")), ("cpu", cpu)):
        fam = _gaussian_family(torch, SVI_D, dev,
                               basis=type(basis)(*(b.to(dev) for b in basis)))
        x = x_cpu.to(dev)
        t0 = time.perf_counter()
        w, idcs, size = sparsevi.svi_build(
            x, torch.zeros(SVI_CAP, device=dev),
            torch.full((SVI_CAP,), -1, dtype=torch.int64, device=dev), 0,
            torch.Generator(device=dev), SVI_M, family=fam, n_sub_sel=None,
            n_sub_opt=None, opt_itrs=SVI_OPT, step_sched=lambda i: 1.0 / (1.0 + i))
        w, ix = w[:size].cpu().numpy(), idcs[:size].cpu().numpy()
        secs[label] = time.perf_counter() - t0
        out[label] = (w, ix)
    (wg, ig), (wc, ic) = out["cuda"], out["cpu"]
    if not np.array_equal(ig, ic):
        k = next((i for i in range(min(ig.size, ic.size)) if ig[i] != ic[i]), min(ig.size, ic.size))
        raise AssertionError(f"svi parity: the index sequences part at select {k}: "
                             f"card {ig[k:k + 5]}, CPU {ic[k:k + 5]}")
    # rtol 1e-3; the atol (1e-6 of the largest weight) covers weights Adam
    # clamped to 0 on one device and left at rounding level on the other
    np.testing.assert_allclose(wg, wc, rtol=1e-3, atol=1e-6 * float(np.abs(wc).max()))
    rel = float(np.max(np.abs(wg - wc) / np.maximum(np.abs(wc), 1e-12)))
    say("svi_parity", N=SVI_N, d=SVI_D, M=SVI_M, size=ig.size, idcs="identical",
        max_rel_weight_diff=f"{rel:.3e}", cuda_s=f"{secs['cuda']:.3f}",
        cpu_s=f"{secs['cpu']:.3f}")


def phase_bpsvi(torch, smi):
    import numpy as np
    from bayesian_coresets_tpu_torch.coresets import bpsvi
    from bayesian_coresets_tpu_torch.ops import opt

    dev = torch.device("cuda")
    x = _gaussian_data(torch, BP_N, BP_D, dev)
    fam = _gaussian_family(torch, BP_D, dev, BP_S, grad=True)
    init = bpsvi.uniform_init_idcs(BP_N, BP_SZ, torch.Generator(device=dev).manual_seed(9))
    sched = lambda i: 1.0 / (1.0 + i)   # noqa: E731
    gen = torch.Generator(device=dev)   # one per run: the graphs are kept per generator

    def one(seed, steps, graphs=None):
        w, p = bpsvi.bpsvi_build(x, init, gen.manual_seed(seed), family=fam, n_sub_opt=BP_SUB,
                                 opt_itrs=steps, step_sched=sched, graphs=graphs)
        return w, p, gen.get_state()

    (w, p, _), kv = _replayed_and_direct(
        torch, "bpsvi", lambda seed, graphs: one(seed, BP_STEPS, graphs), BP_STEPS,
        lambda graphs: one(4, PROFILE_STEPS, graphs), lambda o: o)
    t = float(kv["replayed_s"])
    w0, p0, _ = one(3, 0)                                   # the initialization
    g = torch.Generator(device=dev).manual_seed(5)
    state = g.get_state()
    errs = []
    for ww, pp in ((w0, p0), (w, p)):
        g.set_state(state)                                  # the same draws for both
        errs.append(float(bpsvi.bpsvi_error(x, ww, pp, g, family=fam, n_sub=BP_SUB)))
    xh = x.cpu().numpy()
    rkl0 = _rkl64(xh, w0.cpu().numpy(), p0.cpu().numpy())
    rkl = _rkl64(xh, w.cpu().numpy(), p.cpu().numpy())
    say("bpsvi", N=BP_N, d=BP_D, S=BP_S, sz=BP_SZ, n_sub=BP_SUB, steps=BP_STEPS,
        build_s=f"{t:.4f}", us_per_joint_step=f"{1e6 * t / BP_STEPS:.2f}",
        segment=opt.SEGMENT, replayed_equals_direct="yes", **kv,
        rkl_init=f"{rkl0:.4f}", rkl=f"{rkl:.4f}",
        err_init=f"{errs[0]:.4f}", err=f"{errs[1]:.4f}", card=repr(smi))
    if not (torch.isfinite(w).all() and torch.isfinite(p).all() and bool((w >= 0).all())):
        raise AssertionError("bpsvi: non-finite or negative result")
    for path in ("replayed", "direct"):
        if kv[f"{path}_host_reads"]:
            raise AssertionError(f"bpsvi: {kv[f'{path}_host_reads']} host reads in a {path} "
                                 f"build ({kv[f'{path}_read_sites']})")
    if not rkl < rkl0:
        raise AssertionError(f"bpsvi: rKL {rkl} not below its initialization's {rkl0}")
    if not errs[1] < errs[0]:
        raise AssertionError(f"bpsvi: error {errs[1]} not below its initialization's {errs[0]}")
    if not np.isfinite(rkl):
        raise AssertionError("bpsvi: rKL not finite")


def phase_frankwolfe(torch, smi, Z, projector):
    """Frank-Wolfe at full width, on phase 6's data and projector."""
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    gs.launches = 0
    _fused_reset()
    coreset = bc.HilbertCoreset(Z, projector, snnls=bc.snnls.FrankWolfe,
                                select_dtype=torch.int8, max_active=1024)
    bnorm = float(coreset.snnls.consts.bnorm)
    caps0, cap_s0 = _graph_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coreset.build(50)
    err50 = coreset.error() / bnorm
    coreset.build(M_MAIN - 50)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0        # with the error() read at 50
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    launches = gs.launches
    itr = int(coreset.snnls.state.itr)
    err = coreset.error() / bnorm
    wts, pts, _ = coreset.get()
    if launches != itr or itr != M_MAIN:
        raise AssertionError(f"frankwolfe: {launches} select launches for {itr} iterations")
    _fused_count("frankwolfe", 0)
    one_ms = _one_itr(torch, coreset.snnls.consts, "frankwolfe", (50, M_MAIN - 50),
                      coreset.snnls.state, 1024, "frankwolfe")
    if wts.size != FW_ATOMS:
        raise AssertionError(f"frankwolfe: {wts.size} atoms at M={itr}, expected {FW_ATOMS}")
    if wts.size == 0 or not np.isfinite(wts).all() or (wts <= 0).any() \
            or pts.shape != (wts.size, D_MAIN):
        raise AssertionError("frankwolfe: empty, non-finite or malformed coreset")
    if not err < err50:
        raise AssertionError(f"frankwolfe: error/|b| {err} at M={itr} not below {err50} at 50")
    say("frankwolfe", N=N_MAIN, S=S_MAIN, M=M_MAIN, itr=itr, size=wts.size,
        done=coreset.reached_numeric_limit, launches=launches, err50=f"{err50:.6e}",
        err=f"{err:.6e}", build_s=f"{t_build:.4f}", ms_per_itr=f"{1e3 * t_build / itr:.4f}",
        graphs_captured=caps, capture_s=f"{cap_s:.4f}", one_itr_ms_per_itr=f"{one_ms:.4f}",
        one_itr_bit_identical=True, card=repr(smi))
    _profile_build(torch, coreset.snnls.consts, "frankwolfe", "frankwolfe_launches")
    _profile_build(torch, coreset.snnls.consts, "frankwolfe", "frankwolfe_launches", segment=1)
    return launches, {"w": coreset.snnls.weights(), "err": err, "itr": itr,
                      "slots": _slots(coreset.snnls.state), "ms_per_itr": 1e3 * t_build / itr}


def phase_omp(torch, smi, Z, projector):
    """OMP on phase 6's projection: the error every OMP_CHUNK iterations,
    and the FISTA re-solve's share of an iteration."""
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import nnls, snnls

    gs.launches = 0
    _fused_reset()
    coreset = bc.HilbertCoreset(Z, projector, snnls=bc.snnls.OrthoPursuit,
                                select_dtype=torch.int8, max_active=OMP_ACTIVE)
    bnorm = float(coreset.snnls.consts.bnorm)
    caps0, cap_s0 = _graph_counts()
    inst0 = _instantiate_s()
    errs, secs = [], []
    for _ in range(OMP_ITRS // OMP_CHUNK):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coreset.build(OMP_CHUNK)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        errs.append(coreset.error() / bnorm)
    t_build = sum(secs)
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    launches, itr = gs.launches, int(coreset.snnls.state.itr)
    if launches != itr or itr != OMP_ITRS or coreset.reached_numeric_limit:
        raise AssertionError(f"omp: {launches} select launches for {itr} iterations, "
                             f"latched={coreset.reached_numeric_limit}")
    _fused_count("omp", 0)
    if any(b > a * (1.0 + 1e-6) for a, b in zip(errs, errs[1:])):
        raise AssertionError(f"omp: the error rose: {errs}")
    # the re-solve alone, on the final active set, warm-started as the step does
    st, c = coreset.snnls.state, coreset.snnls.consts
    mask, safe = snnls._active_mask(st.idcs, st.size)
    Aact = torch.where(mask[:, None], c.V.index_select(0, safe), 0.0)
    x0 = torch.where(mask, st.w.index_select(0, safe), 0.0)
    fista_ms = _median_ms(torch, lambda: nnls.nnls_rows(Aact, c.b, mask, num_iters=256, x0=x0),
                          batches=3, per_batch=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        nnls.nnls_rows(Aact, c.b, mask, num_iters=256, x0=x0)
    torch.cuda.synchronize()
    fista_wall_ms = 1e3 * (time.perf_counter() - t0) / 3
    ms_itr = 1e3 * secs[-1] / OMP_CHUNK          # the last chunk: the fullest active set
    say("omp", N=N_MAIN, S=S_MAIN, itr=itr, max_active=OMP_ACTIVE, size=coreset.size(),
        launches=launches, errs=",".join(f"{e:.6e}" for e in errs), build_s=f"{t_build:.4f}",
        chunk_s=",".join(f"{t:.3f}" for t in secs), ms_per_itr_last_chunk=f"{ms_itr:.3f}",
        fista_wall_ms=f"{fista_wall_ms:.3f}", fista_event_ms=f"{fista_ms:.3f}",
        fista_share_of_itr=f"{fista_wall_ms / ms_itr:.3f}", graphs_captured=caps,
        capture_s=f"{cap_s:.3f}", instantiate_s=f"{_instantiate_s() - inst0:.3f}",
        segment=snnls._GRAPH_SEGMENT["orthopursuit"],
        card=repr(smi))
    # a replayed window of 16 iterations (segments of 4) from 33, with
    # OMP_ACTIVE slots: its graph nodes per iteration
    _profile_build(torch, c, "orthopursuit", "omp_launches", max_active=OMP_ACTIVE, warm=33,
                   window=16)
    return launches


def phase_sampling(torch, smi, Z, projector):
    """Importance and uniform sampling on phase 6's projection."""
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps

    gs.launches = ps.launches = 0
    _fused_reset()
    for cls in (bc.snnls.ImportanceSampling, bc.snnls.UniformSampling):
        coreset = bc.HilbertCoreset(Z, projector, snnls=cls, max_active=1024, seed=3)
        sn = coreset.snnls
        bnorm = float(sn.consts.bnorm)
        caps0, cap_s0 = _graph_counts()
        _, syncs, sites = _count_syncs(torch, lambda: coreset.build(SAMPLING_DRAWS))   # warm-up
        caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
        w_first = sn.weights()
        coreset.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coreset.build(SAMPLING_DRAWS)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        w, cts = sn.weights(), sn.state.cts
        err = coreset.error() / bnorm
        gen = torch.Generator(device="cuda")     # one generator: its graphs are replayed

        def window():
            return bc.snnls.build(sn.consts, sn.state, PROFILE_ITRS, 1e-6, method=cls.method,
                                  draws=gen.manual_seed(4))

        window()                                 # captures the window's graphs
        launches, busy_us, idle = _profile_window(torch, window, PROFILE_ITRS)
        say("sampling", method=cls.method, N=N_MAIN, S=S_MAIN, draws=SAMPLING_DRAWS,
            size=coreset.size(), counts=int(cts.sum()), err=f"{err:.6e}",
            build_s=f"{t:.4f}", ms_per_draw=f"{1e3 * t / SAMPLING_DRAWS:.4f}",
            launches_per_draw=launches, device_busy_us_per_draw=busy_us, idle_share=idle,
            host_reads_per_draw=f"{syncs / SAMPLING_DRAWS:.3f}", host_read_sites=sites,
            select_launches=gs.launches + ps.launches, graphs_captured=caps,
            capture_s=f"{cap_s:.4f}", card=repr(smi))
        if int(cts.sum()) != SAMPLING_DRAWS or int(sn.state.itr) != SAMPLING_DRAWS:
            raise AssertionError(f"sampling {cls.method}: {int(cts.sum())} counts after "
                                 f"{int(sn.state.itr)} of {SAMPLING_DRAWS} draws")
        if not (np.isfinite(w).all() and (w >= 0).all() and np.isfinite(err)):
            raise AssertionError(f"sampling {cls.method}: weights or error not finite")
        if not np.array_equal(w, w_first):
            raise AssertionError(f"sampling {cls.method}: reset() and rebuild differ")
        if syncs > SAMPLING_DRAWS + 16:       # done once per draw; the facade's own reads
            raise AssertionError(f"sampling {cls.method}: {syncs} host reads in "
                                 f"{SAMPLING_DRAWS} draws ({sites})")
    if gs.launches or ps.launches:
        raise AssertionError("sampling: a select kernel was launched")
    _fused_count("sampling", 0)


def phase_poisson(torch, smi):
    """The Poisson model end to end: data, projection, a GIGA build, and
    weighted NUTS on the coreset."""
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch import mcmc
    from bayesian_coresets_tpu_torch.mcmc import nuts, weighted
    from bayesian_coresets_tpu_torch.models import poisson
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls

    dev = torch.device("cuda")
    d = 2
    Z = poisson.gen_synthetic(torch.Generator(device=dev).manual_seed(0), N_MAIN)
    # samples around the generating parameter (1, 0), as wide as the
    # posterior of ~1e3 points
    sampler = lambda g, n, w, p: (torch.tensor([1.0, 0.0], device=g.device)   # noqa: E731
                                  + 0.05 * torch.randn((n, d), generator=g, device=g.device))
    projector = bc.BlackBoxProjector(sampler, S_MAIN, poisson.log_likelihood,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    gs.launches = snnls.itrs_run = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coreset = bc.HilbertCoreset(Z, projector, select_dtype=torch.int8, max_active=1024)
    coreset.build(POIS_M)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    launches, ran, itr = gs.launches, snnls.itrs_run, int(coreset.snnls.state.itr)
    err = coreset.error() / float(coreset.snnls.consts.bnorm)
    wts, pts, _ = coreset.get()
    _ran_check("poisson", launches, ran, itr, coreset.reached_numeric_limit)
    if wts.size == 0 or not np.isfinite(wts).all():
        raise AssertionError(f"poisson: {wts.size} atoms, or weights not finite")
    zc, wc = torch.as_tensor(pts, device=dev), torch.as_tensor(wts, device=dev)
    reads, leaves = nuts.host_reads, nuts.leaf_steps
    caps0, _ = _graph_counts()
    _, t, res = weighted.run(poisson, zc, wc, POIS_DRAWS,
                             torch.Generator(device=dev).manual_seed(5), d=d,
                             num_chains=POIS_CHAINS, target_accept=0.8, num_warmup=POIS_DRAWS)
    n = 2 * POIS_DRAWS
    reads, leaves = (nuts.host_reads - reads) / n, (nuts.leaf_steps - leaves) / n
    caps = _graph_counts()[0] - caps0
    samples = res.samples
    if samples.shape != (POIS_CHAINS, POIS_DRAWS, d) or not torch.isfinite(samples).all():
        raise AssertionError(f"poisson nuts: samples {tuple(samples.shape)} or not finite")
    rhat = float(mcmc.split_rhat(samples).max())
    divs = int(res.num_divergent.sum())
    mean = samples.reshape(-1, d).mean(dim=0)
    sd = samples.reshape(-1, d).std(dim=0)
    # the full-data posterior's Laplace fit: the coreset posterior should sit on it
    full = weighted.fit_laplace(poisson, Z, torch.ones(N_MAIN, device=dev), d)
    full_sd = torch.sqrt(torch.diagonal(full.USig @ full.USig.T))
    off = float(((mean - full.mu).abs() / full_sd).max())
    say("poisson", N=N_MAIN, S=S_MAIN, M=POIS_M, itr=itr, atoms=wts.size, launches=launches,
        err=f"{err:.6e}", build_s=f"{t_build:.4f}", chains=POIS_CHAINS, warmup=POIS_DRAWS,
        draws=POIS_DRAWS, nuts_s=f"{t:.3f}", ms_per_transition=f"{1e3 * t / n:.3f}",
        host_reads_per_transition=f"{reads:.2f}", leaf_steps_per_transition=f"{leaves:.2f}",
        nuts_graphs_captured=caps,
        samples_per_s=f"{POIS_CHAINS * POIS_DRAWS / t:.1f}", max_rhat=f"{rhat:.4f}",
        divergences=divs, mean=",".join(f"{v:.4f}" for v in mean.tolist()),
        sd=",".join(f"{v:.5f}" for v in sd.tolist()),
        full_mode=",".join(f"{v:.4f}" for v in full.mu.tolist()),
        mean_minus_full_mode_full_sds=f"{off:.3f}", card=repr(smi))
    if rhat > RHAT_MAX:
        raise AssertionError(f"poisson nuts: max split R-hat {rhat} > {RHAT_MAX}")
    if divs > DIV_SHARE_MAX * POIS_CHAINS * POIS_DRAWS:
        raise AssertionError(f"poisson nuts: {divs} divergences")
    return launches


def _host_logistic(torch, n, seed, dev="cuda"):
    """Logistic data (n, D_MAIN), drawn on the card in STREAM_CHUNK-row
    pieces from one seeded generator and kept on the host (numpy)."""
    import numpy as np
    from bayesian_coresets_tpu_torch.models import logistic

    gen = torch.Generator(device=torch.device(dev)).manual_seed(seed)
    Z = np.empty((n, D_MAIN), np.float32)
    for lo in range(0, n, STREAM_CHUNK):
        hi = min(n, lo + STREAM_CHUNK)
        Z[lo:hi] = logistic.gen_synthetic(gen, hi - lo, D_MAIN).cpu().numpy()
    return Z


def _streamed_select(torch, consts):
    """Kernel 1 on the N=8M int8-resident matrix itself: held against the
    plain version (which runs in 2^20-row blocks) with random directions,
    the winner invalid, and a tie before the winner; then its batch time of
    direct launches beside its bound, the plain version's and the
    ``torch._int_mm`` yardstick's.  Returns (ms, plain ms, bound ms, bound
    by, library ms, largest score error)."""
    from bayesian_coresets_tpu_torch.ops import _cuda_build
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    V, norms, valid = consts.V, consts.norms, consts.valid
    n, Sp = V.shape
    gen = torch.Generator(device=V.device).manual_seed(16)
    dirs = torch.randn((S_MAIN, 2), generator=gen, device=V.device)
    dirs[:, 1] -= dirs[:, 0] * (dirs[:, 0] @ dirs[:, 1]) / (dirs[:, 0] @ dirs[:, 0])
    dirs = (dirs / torch.linalg.vector_norm(dirs, dim=0)).contiguous()
    label = f"streamed select n={n}"
    f, err = _hold(gs.giga_select, gs.giga_select_ref, (V, dirs, norms, valid), f"{label} random")
    ok2 = valid.clone()
    ok2[f] = False
    f2, e2 = _hold(gs.giga_select, gs.giga_select_ref, (V, dirs, norms, ok2),
                   f"{label} invalid_winner")
    if f2 == f:
        raise AssertionError(f"{label}: the invalid row {f} was selected")
    del ok2
    j = f // 2 if f > 1 else n - 1            # a copy of the winner; the first wins
    saved = V[j].clone()
    V[j] = V[f]
    try:
        _, e3 = _hold(gs.giga_select, gs.giga_select_ref, (V, dirs, norms, valid), f"{label} ties",
                      expect_idx=min(j, f))
    finally:
        V[j] = saved
    lib = _cuda_build.load_library()
    ws, stream = gs.workspace(V.device)
    idx = torch.empty(1, dtype=torch.int32, device=V.device)
    score = torch.empty(1, dtype=torch.float32, device=V.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    k_ms = _direct_ms(torch, lib.giga_select_launch, ptr(V), gs._DTYPE_CODE[torch.int8], n, Sp,
                      ptr(dirs), S_MAIN, ptr(norms), ptr(valid), ptr(ws), ptr(idx), ptr(score),
                      ctypes.c_void_p(stream))
    p_ms = _median_ms(torch, lambda: gs.giga_select_ref(V, dirs, norms, valid), batches=3,
                      per_batch=1)
    lib_ms, lib_how = _library_ms(torch, V, dirs)
    bound_ms, bound_by = _select_bound(torch, V, S_MAIN)
    say("streamed_select", dtype="int8", n=n, S=S_MAIN, bytes=V.numel(),
        kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, share_of_bound=f"{bound_ms / k_ms:.3f}",
        kernel_GBps=f"{V.numel() / (k_ms * 1e-3) / 1e9:.1f}",
        library_dots_only_ms="not_run" if lib_ms is None else f"{lib_ms:.4f}",
        library=lib_how, max_abs_err=max(err, e2, e3), checks="random,invalid_winner,ties")
    if not bound_ms / k_ms >= 0.5:
        raise AssertionError(f"{label}: {k_ms} ms, under half of its bound {bound_ms} ms")
    return k_ms, p_ms, bound_ms, bound_by, lib_ms, max(err, e2, e3)


def phase_streamed(torch, smi):
    """bench.py's N=8M arm through the port's entry point: the streamed
    int8-resident construction and a GIGA build of M_MAIN, the select at
    that shape, the N=1M quality arm, and OMP and importance sampling from
    the N=1M int8-resident constants."""
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    Z = _host_logistic(torch, STREAM_N, seed=100)
    t_data = time.perf_counter() - t0

    def projector():
        return bc.BlackBoxProjector(_near_map_sampler, S_MAIN, logistic.log_likelihood,
                                    generator=torch.Generator(device=dev).manual_seed(7))

    profiling.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gs.launches = 0
    _fused_reset()
    with profiling.phase("construct", sync=dev):
        coreset = bc.HilbertCoreset(Z, projector(), stream_chunk_size=STREAM_CHUNK,
                                    max_active=1024)
    c8 = coreset.snnls.consts
    if c8.V.dtype != torch.int8 or c8.Vsel is not c8.V \
            or tuple(c8.V.shape) != (STREAM_N, -(-S_MAIN // 16) * 16):
        raise AssertionError(f"streamed: constants {c8.V.dtype} {tuple(c8.V.shape)}")
    bnorm = float(c8.bnorm)
    with profiling.phase("build", sync=dev):
        coreset.build(50)
    s50 = coreset.snnls.state          # mid-build: the fused kernels' hold starts here
    err50 = coreset.error() / bnorm
    with profiling.phase("build", sync=dev):
        coreset.build(M_MAIN - 50)
    peak = torch.cuda.max_memory_allocated()
    launches, itr = gs.launches, int(coreset.snnls.state.itr)
    _fused_count("streamed", launches)
    err = coreset.error() / bnorm
    wts, pts, idcs = coreset.get()
    one_ms = _one_itr(torch, c8, "giga", (50, M_MAIN - 50), coreset.snnls.state, 1024,
                      "streamed")
    rep = profiling.report()
    t_con, t_build = rep["construct"]["total_s"], rep["build"]["total_s"]
    say("streamed", N=STREAM_N, D=D_MAIN, S=S_MAIN, M=M_MAIN, chunk=STREAM_CHUNK, itr=itr,
        size=wts.size, done=coreset.reached_numeric_limit, launches=launches,
        select_launches_per_itr=f"{launches / max(itr, 1):.3f}", err50=f"{err50:.6e}",
        err=f"{err:.6e}", data_s=f"{t_data:.3f}", construct_s=f"{t_con:.4f}",
        build_s=f"{t_build:.4f}", ms_per_itr=f"{1e3 * t_build / max(itr, 1):.4f}",
        points_per_s=f"{M_MAIN / (t_con + t_build):.2f}", peak_mem_GB=f"{peak / 1e9:.3f}",
        f32_matrix_GB=f"{STREAM_N * S_MAIN * 4 / 1e9:.3f}",
        one_itr_ms_per_itr=f"{one_ms:.4f}", one_itr_bit_identical=True, card=repr(smi))
    if launches != itr or itr != M_MAIN:
        raise AssertionError(f"streamed: {launches} select launches for {itr} iterations")
    if wts.size == 0 or not np.isfinite(wts).all() or (wts <= 0).any() \
            or pts.shape != (wts.size, D_MAIN) or not np.array_equal(pts, Z[idcs]):
        raise AssertionError("streamed: empty, non-finite or malformed coreset")
    if not err < err50:
        raise AssertionError(f"streamed: error/|b| {err} at M={itr} not below {err50} at 50")
    if not peak < STREAM_MEM_MAX:
        raise AssertionError(f"streamed: peak allocation {peak / 1e9:.3f} GB, not below the "
                             f"{STREAM_MEM_MAX / 1e9} GB of an f32 (N, S) matrix")
    prof = _profile_build(torch, c8, "giga", "streamed_launches")
    _profile_build(torch, c8, "giga", "streamed_launches", segment=1)
    # the wscale fold gated on the device, a GIGA iteration's one O(N) pass
    # where its plain version runs: the kernel and the plain version at N
    fold = _hold_fold(torch, STREAM_N, "streamed_fold_kernel", smi)
    _hold_giga_step(torch, c8, s50, "streamed_giga_step_kernels", smi)
    itr_ms = prof["unprofiled_wall_ms_per_itr"]
    say("streamed_fold", N=STREAM_N, itr_wall_ms=f"{itr_ms:.4f}",
        plain_share_of_itr=f"{fold[False]['plain_ms'] / itr_ms:.4f}",
        kernel_share_of_itr=f"{fold[False]['graph_ms'] / itr_ms:.4f}",
        kernel_set_share_of_itr=f"{fold[True]['graph_ms'] / itr_ms:.4f}", card=repr(smi))
    select = _streamed_select(torch, c8)
    del coreset, c8, wts, pts
    torch.cuda.empty_cache()

    # the N=1M quality arm: the in-memory int8 select and the streamed
    # int8-resident path, from the same data and projector
    Z1 = Z[:QUALITY_N]
    proj = projector()
    mem = bc.HilbertCoreset(torch.as_tensor(Z1, device=dev), proj, select_dtype=torch.int8,
                            max_active=1024)
    gs.launches = 0
    _fused_reset()
    st = bc.HilbertCoreset(Z1, proj, stream_chunk_size=QUALITY_CHUNK, max_active=1024)
    cm, cs = mem.snnls.consts, st.snnls.consts
    diff = (cm.Vsel.short() - cs.V.short()).abs()
    n_diff, max_diff = int(torch.count_nonzero(diff)), int(diff.max())
    del diff
    norm_rel = float(((cm.norms - cs.norms).abs() / cs.norms).max())
    e0 = st.error() / float(cs.bnorm)
    snnls.itrs_run = 0
    mem.build(M_MAIN)
    st.build(M_MAIN)
    q_launches, q_ran = gs.launches, snnls.itrs_run
    e_mem, e_st = mem.error() / float(cm.bnorm), st.error() / float(cs.bnorm)
    say("streamed_quality", N=QUALITY_N, chunk=QUALITY_CHUNK, M=M_MAIN,
        int8_entries_differing=n_diff, max_int8_diff=max_diff, norms_max_rel=f"{norm_rel:.3e}",
        err0=f"{e0:.6e}", err_in_memory=f"{e_mem:.6e}", err_streamed=f"{e_st:.6e}",
        atoms_in_memory=mem.size(), atoms_streamed=st.size(), streamed_launches=q_launches)
    if max_diff > 1:
        raise AssertionError(f"streamed quality: int8 rows differ by {max_diff}")
    if not norm_rel <= 1e-5:
        raise AssertionError(f"streamed quality: norms differ by {norm_rel} relative")
    if not e_st < max(2.0 * e_mem, 0.05 * e0):       # tests/test_snnls.py:279's rule
        raise AssertionError(f"streamed quality: error/|b| {e_st} against in-memory {e_mem}")
    _ran_check("streamed quality", q_launches, q_ran,
               int(st.snnls.state.itr) + int(mem.snnls.state.itr),
               st.reached_numeric_limit or mem.reached_numeric_limit, length=128)
    _fused_count("streamed quality", q_ran)
    quality = {"V": cs.V.cpu().numpy(), "norms": cs.norms.cpu().numpy(),
               "w": st.snnls.weights(), "err_in_memory": e_mem, "err0": e0, "err": e_st,
               "itr": int(st.snnls.state.itr)}
    del mem, cm
    torch.cuda.empty_cache()

    # OMP and importance sampling from the N=1M int8-resident constants
    gs.launches = 0
    _fused_reset()
    omp = bc.snnls.OrthoPursuit.from_consts(cs, max_active=STREAM_OMP_ACTIVE)
    errs = [omp.error() / float(cs.bnorm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STREAM_OMP_ITRS // STREAM_OMP_CHUNK):
        omp.build(STREAM_OMP_CHUNK)
        errs.append(omp.error() / float(cs.bnorm))
    torch.cuda.synchronize()
    t_omp = time.perf_counter() - t0
    omp_launches, omp_itr = gs.launches, int(omp.state.itr)
    say("streamed_omp", N=QUALITY_N, itr=omp_itr, max_active=STREAM_OMP_ACTIVE,
        size=omp.size(), launches=omp_launches, errs=",".join(f"{e:.6e}" for e in errs),
        ms_per_itr=f"{1e3 * t_omp / max(omp_itr, 1):.3f}")
    if omp_launches != omp_itr or omp_itr != STREAM_OMP_ITRS:
        raise AssertionError(f"streamed omp: {omp_launches} select launches for {omp_itr}")
    if not all(np.isfinite(errs)) or any(b > a * (1.0 + 1e-6) for a, b in zip(errs, errs[1:])) \
            or not errs[-1] < errs[0]:
        raise AssertionError(f"streamed omp: the error did not fall: {errs}")
    ci = bc.snnls.make_consts_quantized(cs.V, cs.norms, cs.b, valid=cs.valid,
                                        sampling="importance")
    if ci.V.data_ptr() != cs.V.data_ptr():
        raise AssertionError("streamed sampling: the int8 matrix was copied")
    gs.launches = 0
    imp = bc.snnls.ImportanceSampling.from_consts(ci, seed=3, max_active=1024)
    e_imp0 = imp.error() / float(ci.bnorm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imp.build(STREAM_DRAWS)
    torch.cuda.synchronize()
    t_imp = time.perf_counter() - t0
    e_imp, w_imp = imp.error() / float(ci.bnorm), imp.weights()
    say("streamed_sampling", method="importance", N=QUALITY_N, draws=STREAM_DRAWS,
        size=imp.size(), counts=int(imp.state.cts.sum()), err0=f"{e_imp0:.6e}",
        err=f"{e_imp:.6e}", ms_per_draw=f"{1e3 * t_imp / STREAM_DRAWS:.4f}",
        select_launches=gs.launches)
    if gs.launches or int(imp.state.cts.sum()) != STREAM_DRAWS:
        raise AssertionError(f"streamed sampling: {gs.launches} select launches, "
                             f"{int(imp.state.cts.sum())} counts")
    if not (np.isfinite(w_imp).all() and (w_imp >= 0).all() and e_imp < e_imp0):
        raise AssertionError(f"streamed sampling: error {e_imp} from {e_imp0}, or bad weights")
    _fused_count("streamed omp and sampling", 0)
    return launches, q_launches, omp_launches, select, quality


def phase_wide_build(torch, smi):
    """A Hilbert build whose select runs on the wide-row kernel: phase 6's
    data, a BlackBoxProjector of WIDE_BUILD_S samples by bench.py's rule, the
    default f32 select copy (V itself), GIGA and then Frank-Wolfe, M =
    WIDE_BUILD_M each.  Returns the select launches of both builds and the
    GIGA build's weights, error and atoms."""
    import numpy as np
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    dev = torch.device("cuda")
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), N_MAIN, D_MAIN)
    projector = bc.BlackBoxProjector(_near_map_sampler, WIDE_BUILD_S, logistic.log_likelihood,
                                     generator=torch.Generator(device=dev).manual_seed(1))
    total = 0
    for method, cls in (("giga", bc.snnls.GIGA), ("frankwolfe", bc.snnls.FrankWolfe)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gs.launches = 0
        _fused_reset()
        t0 = time.perf_counter()
        coreset = bc.HilbertCoreset(Z, projector, snnls=cls, max_active=1024)
        torch.cuda.synchronize()
        t_proj = time.perf_counter() - t0
        c = coreset.snnls.consts
        row_bytes = c.Vsel.shape[1] * c.Vsel.element_size()
        if c.Vsel.dtype != torch.float32 or c.Vsel.data_ptr() != c.V.data_ptr() \
                or row_bytes <= 48 * 1024:
            raise AssertionError(f"wide build: a {c.Vsel.dtype} select copy of {row_bytes}-byte "
                                 "rows, not V itself past 48 KB")
        bnorm = float(c.bnorm)
        caps0, cap_s0 = _graph_counts()
        coreset.build(1)
        err1 = coreset.error() / bnorm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coreset.build(WIDE_BUILD_M - 1)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
        launches, itr = gs.launches, int(coreset.snnls.state.itr)
        _fused_count(f"wide build {method}", launches if method == "giga" else 0)
        err = coreset.error() / bnorm
        peak = torch.cuda.max_memory_allocated()
        wts, pts, _ = coreset.get()
        one_ms = _one_itr(torch, c, method, (1, WIDE_BUILD_M - 1), coreset.snnls.state, 1024,
                          f"wide build {method}")
        if method == "giga" and wts.size != WIDE_GIGA_ATOMS:
            raise AssertionError(f"wide build giga: {wts.size} atoms, expected "
                                 f"{WIDE_GIGA_ATOMS}")
        say("wide_build", method=method, N=N_MAIN, S=WIDE_BUILD_S, row_bytes=row_bytes,
            M=WIDE_BUILD_M, itr=itr, size=wts.size, done=coreset.reached_numeric_limit,
            launches=launches, select_launches_per_itr=f"{launches / max(itr, 1):.3f}",
            err1=f"{err1:.6e}", err=f"{err:.6e}", projection_s=f"{t_proj:.4f}",
            ms_per_itr=f"{1e3 * t_build / (WIDE_BUILD_M - 1):.4f}",
            graphs_captured=caps, capture_s=f"{cap_s:.4f}", one_itr_ms_per_itr=f"{one_ms:.4f}",
            one_itr_bit_identical=True, peak_mem_GB=f"{peak / 1e9:.3f}", card=repr(smi))
        if launches != itr or itr != WIDE_BUILD_M:
            raise AssertionError(f"wide build {method}: {launches} select launches for {itr} "
                                 "iterations")
        if method == "giga":
            _hold_giga_step(torch, c, coreset.snnls.state, "wide_giga_step_kernels", smi)
        if not (np.isfinite(err) and err <= err1):
            raise AssertionError(f"wide build {method}: error/|b| {err} at M against {err1} "
                                 "after the first iteration")
        if wts.size == 0 or not np.isfinite(wts).all() or (wts <= 0).any() \
                or pts.shape != (wts.size, D_MAIN):
            raise AssertionError(f"wide build {method}: empty, non-finite or malformed coreset")
        total += launches
        if method == "giga":
            ref = {"w": coreset.snnls.weights(), "err": err, "itr": itr,
                   "slots": _slots(coreset.snnls.state),
                   "ms_per_itr": 1e3 * t_build / (WIDE_BUILD_M - 1)}
        bound_ms, _ = _select_bound(torch, c.Vsel, WIDE_BUILD_S)
        for segment in (None, 1):
            _profile_build(torch, c, method, "wide_build_launches", select_bound_ms=bound_ms,
                           card=smi, segment=segment)
        del coreset, c
    return total, ref


@contextlib.contextmanager
def _in_temp_dir():
    """Run a block in a fresh temporary working directory (removed after)."""
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        yield Path(tmp)


def _exp_line(name, t, launches, itr, table, keys, reduced, **kv):
    last = {k: f"{float(table[k][-1]):.6g}" for k in keys}
    say("experiments", driver=name, seconds=f"{t:.3f}", select_launches=launches,
        iterations=itr, **{f"{k}_at_Mmax": v for k, v in last.items()}, **kv,
        reduced=reduced or "none")


def _finite_columns(table, name):
    import numpy as np
    for k in table.columns:
        col = table[k]
        if col.dtype.kind in "fiub" and not np.isfinite(col.astype(float)).all():
            raise AssertionError(f"{name}: column {k} is not finite: {col}")


def _driver_select_args(torch, coreset):
    """A driver's own select copy with GIGA's directions from the build's
    end state (b and xw): (Vsel, dirs, norms, valid)."""
    c, st = coreset.snnls.consts, coreset.snnls.state
    bn = c.b / torch.linalg.vector_norm(c.b)
    xwn = st.xw / torch.linalg.vector_norm(st.xw)
    cd = bn - (bn @ xwn) * xwn
    dirs = torch.stack([cd / torch.linalg.vector_norm(cd), xwn], dim=1).contiguous()
    return [c.Vsel, dirs, c.norms, c.valid]


def _hold_driver_select(torch, coreset, label):
    """Kernel 1 against its plain version on a driver's own select copy
    (``_driver_select_args``), then with the winner dead, then with copies
    of the winner before and after it.  Returns the largest score error;
    the launches are not counted."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    return _hold_wide(torch, gs.giga_select, gs.giga_select_ref,
                      _driver_select_args(torch, coreset), _kill, label,
                      scale=lambda a, f: _f32_scale(torch, a, f))


@contextlib.contextmanager
def _data_dir(name, **arrays):
    """A temporary working directory whose ``data/name.npz`` holds
    ``arrays``, read through BC_DATA_DIR: the runs of one dataset share it,
    and the full-data chains that the first run caches in it."""
    import numpy as np
    with _in_temp_dir() as tmp:
        (tmp / "data").mkdir()
        np.savez(tmp / "data" / f"{name}.npz", **arrays)
        prev = os.environ.get("BC_DATA_DIR")
        os.environ["BC_DATA_DIR"] = str(tmp / "data")
        try:
            yield tmp
        finally:
            if prev is None:
                del os.environ["BC_DATA_DIR"]
            else:
                os.environ["BC_DATA_DIR"] = prev


def _logistic_data():
    """``_data_dir`` with phase 18's logistic data."""
    import numpy as np
    rng = np.random.default_rng(EXP_SEED)
    X = np.hstack([rng.normal(size=(EXP_N, EXP_D - 1)), np.ones((EXP_N, 1))])
    y = np.where(rng.uniform(size=EXP_N) < 1.0 / (1.0 + np.exp(-X @ np.ones(EXP_D))),
                 1.0, -1.0)
    return _data_dir("synth_lr_N100k", X=X, y=y)


def _poisson_data():
    """``_data_dir`` with phase 18's Poisson data: EXP_N training rows and
    EXP_POIS_NT held out, EXP_D columns (N(0, 1) covariates, the intercept
    last) and counts from the model's link, y ~ Poisson(softplus(x . theta))
    (models/poisson.py::gen_synthetic), theta spreading gen_synthetic's unit
    slope over the covariates (x . theta ~ N(0, 1)) with intercept 0."""
    import numpy as np
    rng = np.random.default_rng(EXP_SEED + 1)
    theta = np.append(np.full(EXP_D - 1, (EXP_D - 1) ** -0.5), 0.0)

    def rows(n):
        X = np.hstack([rng.normal(size=(n, EXP_D - 1)), np.ones((n, 1))])
        return X, rng.poisson(np.logaddexp(0.0, X @ theta)).astype(np.float64)

    (X, y), (Xt, yt) = rows(EXP_N), rows(EXP_POIS_NT)
    return _data_dir("synth_poiss_N100k", X=X, y=y, Xt=Xt, yt=yt)


def _lp_argv(model, **flags):
    """EXP_LP_ARGV for ``--model model`` (its dataset) with ``flags`` set."""
    argv = list(EXP_LP_ARGV)
    flags = {"model": model, "dataset": EXP_LP_DATASETS[model], **flags}
    for k, v in flags.items():
        argv[argv.index(f"--{k}") + 1] = str(v)
    return argv


def _exp_logistic(torch, gs, alg="GIGA-OPT", model="lr"):
    """logistic_poisson ``--alg alg`` (GIGA-OPT, GIGA-REAL or US) at the
    reference's logistic settings, in the directory of ``model``'s data
    (``_logistic_data``, ``_poisson_data``; the first run there caches the
    full-data chains).  Returns (select launches, the score error of kernel
    1 held on the run's select copy; 0.0 for US)."""
    import numpy as np
    from bayesian_coresets_tpu_torch.experiments import logistic_poisson

    name = "logistic_poisson" if (alg, model) == ("GIGA-OPT", "lr") else \
        f"logistic_poisson_{'' if model == 'lr' else model + '_'}{alg}"
    hilbert = alg != "US"
    r = _drive(torch, gs, logistic_poisson.main, _lp_argv(model, alg=alg),
               {"alg": alg, "model": model})
    info, table, t, launches, ran = r["out"], r["table"], r["t"], r["launches"], r["ran"]
    coreset = info["coreset"]
    itr = int(coreset.snnls.state.itr) if hilbert else 0
    wts, _, _ = coreset.get()
    _finite_columns(table, name)
    rkl = table["rklw"]
    sec = info["seconds"]
    hold = {}
    if hilbert:
        Vsel = coreset.snnls.consts.Vsel
        hold = dict(select_held=f"{Vsel.dtype}:{tuple(Vsel.shape)}",
                    select_max_abs_err=_hold_driver_select(torch, coreset, f"{name} select"))
    _exp_line(name, t, launches, itr, table,
              ("rklw", "fklw", "mu_errs", "Sig_errs", "Fs", "csizes", "rhats", "esses"),
              f"mcmc_samples_full:10000->{EXP_MCMC},mcmc_samples_coreset:10000->{EXP_MCMC},"
              f"coreset_num_sizes:7->{EXP_SIZES}",
              model=model, N=EXP_N, D=EXP_D, Ms=",".join(str(int(m)) for m in table["Ms"]),
              rklw=",".join(f"{v:.5g}" for v in rkl),
              full_rhat=f"{float(table['full_rhat'][0]):.4f}",
              full_ess=f"{float(table['full_ess'][0]):.1f}",
              dense_retries=info["dense_retries"], max_weight=f"{wts.max():.6g}",
              max_weight_over_N=f"{wts.max() / EXP_N:.4g}", iterations_run=ran,
              graphs_captured=r["caps"], capture_s=f"{r['cap_s']:.3f}",
              instantiate_s=f"{r['inst_s']:.3f}", **hold,
              **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()})
    if hilbert:
        _ran_check(name, launches, ran, itr, coreset.reached_numeric_limit)
    elif launches or ran:
        raise AssertionError(f"{name}: {launches} select launches, {ran} solver iterations")
    if not rkl[-1] < EXP_RKL_FALL * rkl[0]:
        raise AssertionError(f"{name}: rKL at M_max {rkl[-1]} not below {EXP_RKL_FALL} x "
                             f"{rkl[0]}")
    if not (table["csizes"] > 0).all():
        raise AssertionError(f"{name}: empty coresets {table['csizes']}")
    # GIGA-OPT on this data puts more than N on one atom in the JAX package
    # too (tests/test_torch_experiments.py::
    # test_logistic_giga_opt_puts_more_than_n_on_an_atom_in_both_packages,
    # on 10k of these rows), so the weights are held to be finite and
    # positive, and printed beside N
    if not (np.isfinite(wts).all() and (wts > 0).all()):
        raise AssertionError(f"{name}: weights not finite and positive: {wts}")
    return launches, hold.get("select_max_abs_err", 0.0)


@contextlib.contextmanager
def _adam_reads(torch):
    """Counts the host reads made inside ``nn_opt``'s segments while the
    block runs, and the Adam steps they ran directly (a replayed segment
    runs no Python and cannot read; a capture raises on a read)."""
    import collections
    import warnings
    from bayesian_coresets_tpu_torch.ops import opt

    seg = opt._segment
    counts = {"reads": 0, "direct_steps": 0, "sites": collections.Counter()}

    def counted(grad_fn, gen, hyper, n, s, p):
        if torch.cuda.is_current_stream_capturing():
            return seg(grad_fn, gen, hyper, n, s, p)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = seg(grad_fn, gen, hyper, n, s, p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for w in caught:
            if "called a synchronizing CUDA operation" in str(w.message):
                counts["reads"] += 1
                counts["sites"][f"{Path(w.filename).name}:{w.lineno}"] += 1
        counts["direct_steps"] += n
        return out

    opt._segment = counted
    try:
        yield counts
    finally:
        opt._segment = seg


def _exp_logistic_adam(torch, gs, alg, model, M, sizes):
    """logistic_poisson ``--alg SVI`` or ``BPSVI`` at the reference's
    settings, in the directory of ``model``'s data (whose full-data chains
    the GIGA-OPT run cached), with the sizes cut to ``sizes`` up to ``M``
    (each SparseVI select and each BatchPSVI size is 100 Adam steps)."""
    import numpy as np
    from bayesian_coresets_tpu_torch.experiments import logistic_poisson
    from bayesian_coresets_tpu_torch.ops import opt

    r = _drive(torch, gs, logistic_poisson.main,
               _lp_argv(model, alg=alg, coreset_size_max=M, coreset_num_sizes=sizes),
               {"alg": alg, "model": model})
    info, table, t, steps, reads, caps = (r[k] for k in ("out", "table", "t", "steps",
                                                         "reads", "caps"))
    wts, _, _ = info["coreset"].get()
    sec = info["seconds"]
    name = f"logistic_poisson_{'' if model == 'lr' else model + '_'}{alg}"
    _finite_columns(table, name)
    rkl = table["rklw"]
    Ms = [int(m) for m in table["Ms"]]
    want = (Ms[-1] if alg == "SVI" else len(Ms)) * EXP_ADAM_OPT    # selects; builds
    say("experiments", driver=name, seconds=f"{t:.3f}", model=model, N=EXP_N, D=EXP_D,
        Ms=",".join(map(str, Ms)), adam_steps=steps,
        adam_steps_direct=reads["direct_steps"],
        build_us_per_adam_step=f"{1e6 * sec['build'] / max(steps, 1):.2f}",
        host_reads_in_adam_steps=reads["reads"],
        host_reads_per_adam_step=f"{reads['reads'] / max(steps, 1):.4f}",
        read_sites=",".join(f"{k}*{v}" for k, v in reads["sites"].items()) or "none",
        graphs_captured=caps, capture_s=f"{r['cap_s']:.3f}",
        instantiate_s=f"{r['inst_s']:.3f}", segment=opt.SEGMENT,
        rklw=",".join(f"{v:.5g}" for v in rkl),
        csizes=",".join(str(int(c)) for c in table["csizes"]),
        **{f"{k}_at_Mmax": f"{float(table[k][-1]):.6g}"
           for k in ("fklw", "mu_errs", "Sig_errs", "Fs", "rhats", "esses")},
        dense_retries=info["dense_retries"], max_weight=f"{wts.max():.6g}",
        build_share=f"{sec['build'] / t:.4f}",
        nuts_share=f"{(sec['full_nuts'] + sec['coreset_nuts']) / t:.4f}",
        **{f"{k}_s": f"{v:.3f}" for k, v in sec.items()},
        reduced=f"coreset_size_max:1000->{M},coreset_num_sizes:7->{sizes},"
                f"mcmc_samples_full:10000->{EXP_MCMC},mcmc_samples_coreset:10000->{EXP_MCMC}")
    if steps != want:
        raise AssertionError(f"{name}: {steps} Adam steps, expected {want}")
    if r["launches"]:
        raise AssertionError(f"{name}: {r['launches']} select launches")
    if reads["reads"]:
        raise AssertionError(f"{name}: {reads['reads']} host reads in the Adam steps "
                             f"({dict(reads['sites'])})")
    if not caps:
        raise AssertionError(f"{name}: no graph was captured: the Adam steps did not replay")
    if not (table["csizes"] > 0).all():
        raise AssertionError(f"{name}: empty coresets {table['csizes']}")
    if not (np.isfinite(wts).all() and (wts >= 0).all() and wts.size):
        raise AssertionError(f"{name}: weights not finite and nonnegative: {wts}")
    if alg == "SVI" and not rkl[-1] < EXP_RKL_FALL * rkl[0]:
        raise AssertionError(f"{name}: rKL at M_max {rkl[-1]} not below {EXP_RKL_FALL} x "
                             f"{rkl[0]}")
    if not np.isfinite(rkl).all():
        raise AssertionError(f"{name}: rKL not finite: {rkl}")


def _exp_simple_lr(gs):
    from bayesian_coresets_tpu_torch.experiments import simple_lr
    from bayesian_coresets_tpu_torch.ops import snnls

    gs.launches = snnls.itrs_run = 0
    caps0, cap_s0 = _graph_counts()
    t0 = time.perf_counter()
    kl, coreset = simple_lr.main(verbose=False)
    t = time.perf_counter() - t0
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    launches, ran, itr = gs.launches, snnls.itrs_run, int(coreset.snnls.state.itr)
    wts, _, _ = coreset.get()
    say("experiments", driver="simple_lr", seconds=f"{t:.3f}", select_launches=launches,
        iterations=itr, iterations_run=ran, kl=f"{kl:.6g}", size=wts.size,
        max_weight=f"{wts.max():.6g}", graphs_captured=caps, capture_s=f"{cap_s:.3f}",
        N=10000, D=10, projection_dim=500, M=500, reduced="none")
    _ran_check("simple_lr", launches, ran, itr, coreset.reached_numeric_limit)
    if not (kl >= 0.0 and kl < float("inf")):
        raise AssertionError(f"simple_lr: KL {kl}")
    return launches


def _exp_synthetic_vectors(torch, gs):
    """synthetic_vectors at its defaults: GIGA and FW on the card and with
    --device cpu in this process (the same sizes and errors below
    data_dim), and kernel 1 held to its plain version on GIGA's select
    copy; OMP on the card at M=EXP_OMP_M.  Returns (select launches, the
    hold's score error)."""
    import numpy as np
    from bayesian_coresets_tpu_torch.experiments import synthetic_vectors

    ran = {}

    def run(alg, extra):
        with _in_temp_dir():
            r = _drive(torch, gs, synthetic_vectors.main, ["--alg", alg] + extra)
        ran.update(itrs=r["ran"], graphs=[r["caps"], r["cap_s"]])
        return r["t"], r["launches"], r["out"], r["table"]

    total, hold_err, dim = 0, 0.0, 100          # the driver's default data_dim
    for alg, extra in (("GIGA", []), ("FW", []),
                       ("OMP", ["--coreset_size_max", str(EXP_OMP_M)])):
        t, launches, coreset, table = run(alg, extra)
        card_ran, (caps, cap_s) = ran["itrs"], ran["graphs"]
        itr = int(coreset.snnls.state.itr)
        _finite_columns(table, f"synthetic_vectors {alg}")
        err = table["err"]
        cpu_kv = {}
        if alg == "GIGA":
            Vsel = coreset.snnls.consts.Vsel
            hold_err = _hold_driver_select(torch, coreset, "synthetic_vectors select")
            cpu_kv.update(select_held=f"{Vsel.dtype}:{tuple(Vsel.shape)}",
                          select_max_abs_err=hold_err)
        if not extra:
            t_cpu, cpu_launches, _, cpu = run(alg, ["--device", "cpu"])
            below = cpu["csize"] < dim
            diff = np.abs(err - cpu["err"])
            tol = EXP_SV_RTOL * np.abs(cpu["err"]) + EXP_SV_ATOL * np.max(cpu["err"])
            last = np.flatnonzero(below)[-1]
            cpu_kv.update(cpu_seconds=f"{t_cpu:.3f}", cpu_err_at_Mmax=f"{cpu['err'][-1]:.6g}",
                          sizes_below_data_dim=int(below.sum()),
                          max_err_diff_below_data_dim=f"{np.max(diff[below]):.3g}",
                          max_err_diff_over_tol=f"{np.max(diff[below] / tol[below]):.3g}")
            if cpu_launches:
                raise AssertionError(f"synthetic_vectors {alg}: {cpu_launches} select "
                                     "launches on the CPU")
            if not np.array_equal(table["csize"][below], cpu["csize"][below]):
                raise AssertionError(f"synthetic_vectors {alg}: card and CPU sizes differ "
                                     f"below data_dim: {table['csize']} against {cpu['csize']}")
            if not (diff[below] <= tol[below]).all():
                raise AssertionError(f"synthetic_vectors {alg}: card errors {err} against "
                                     f"CPU {cpu['err']} below data_dim")
            for name, e in (("card", err), ("cpu", cpu["err"])):
                if not e[-1] <= e[last]:
                    raise AssertionError(f"synthetic_vectors {alg}: {name} error {e[-1]} at "
                                         f"M_max above {e[last]} at size {last}")
        _exp_line(f"synthetic_vectors_{alg}", t, launches, itr, table, ("err", "csize"),
                  f"coreset_size_max:1000->{EXP_OMP_M}" if extra else "none",
                  data_num=10000, data_dim=dim, sizes=table.nrows,
                  ms_per_itr=f"{1e3 * float(table['cput'][-1]) / max(itr, 1):.4f}",
                  iterations_run=card_ran, graphs_captured=caps, capture_s=f"{cap_s:.3f}",
                  **cpu_kv)
        _ran_check(f"synthetic_vectors {alg}", launches, card_ran, itr,
                   coreset.reached_numeric_limit, length=4 if alg == "OMP" else 64)
        if not err[-1] < err[0]:
            raise AssertionError(f"synthetic_vectors {alg}: error {err[-1]} at M_max not "
                                 f"below {err[0]}")
        total += launches
    # US: uniform draws, no select; its error at M_max below EXP_RKL_FALL_CLOSED
    # x its first size's
    t, launches, coreset, table = run("US", [])
    err = table["err"]
    _finite_columns(table, "synthetic_vectors US")
    _exp_line("synthetic_vectors_US", t, launches, int(coreset.snnls.state.itr), table,
              ("err", "csize"), "none", data_num=10000, data_dim=dim, sizes=table.nrows,
              iterations_run=ran["itrs"], graphs_captured=ran["graphs"][0],
              capture_s=f"{ran['graphs'][1]:.3f}")
    if launches:
        raise AssertionError(f"synthetic_vectors US: {launches} select launches")
    if not (table["csize"] > 0).all():
        raise AssertionError(f"synthetic_vectors US: empty coresets {table['csize']}")
    if not err[-1] < EXP_RKL_FALL_CLOSED * err[0]:
        raise AssertionError(f"synthetic_vectors US: error {err[-1]} at M_max not below "
                             f"{EXP_RKL_FALL_CLOSED} x {err[0]}")
    return total, hold_err


@contextlib.contextmanager
def _patched(obj, **attrs):
    """``obj``'s attributes set to ``attrs`` while the block runs."""
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


_BUILT: set = set()      # (a build's graph set key, size grid) of phase 18's runs so far


def _drive(torch, gs, main, argv, match=None):
    """One run of a driver's ``main(["run"] + argv)`` in the working
    directory, with its select launches, solver iterations run, Adam steps,
    graphs and the host reads inside its Adam steps counted, and the rows
    of ``results/`` that match ``match`` (all by default).  Prints the
    run's captures by kind and their seconds (``[experiments_graphs]``),
    and fails where it captured a build graph though every build set it
    used had built over the same size grid in an earlier run, or captured
    more than SET_KEYS_MAX build graphs a set."""
    import numpy as np
    from bayesian_coresets_tpu_torch.experiments import results
    from bayesian_coresets_tpu_torch.ops import graphs, opt, snnls

    used, graphs_for = set(), graphs.graphs_for

    def spy(tensors, key, *args, **kw):
        if key[0] == "build":
            used.add(graphs.set_key(tensors, key, graphs._stream(tensors[0].device),
                                    kw.get("shared", False)))
        return graphs_for(tensors, key, *args, **kw)

    gs.launches = snnls.itrs_run = opt.steps_run = 0
    caps0, cap_s0 = _graph_counts()
    kinds0, kind_s0 = dict(graphs.captures_by_kind), dict(graphs.capture_s_by_kind)
    inst0 = _instantiate_s()
    t0 = time.perf_counter()
    with _adam_reads(torch) as reads, _patched(graphs, graphs_for=spy):
        out = main(["run"] + argv)
    t = time.perf_counter() - t0
    caps, cap_s = (a - b for a, b in zip(_graph_counts(), (caps0, cap_s0)))
    table = results.load_matching(match or {}, folder="results/")
    kinds = {k: (n - kinds0.get(k, 0), graphs.capture_s_by_kind[k] - kind_s0.get(k, 0.0))
             for k, n in graphs.captures_by_kind.items()}
    grid = tuple(np.asarray(table["Ms"]).ravel().tolist()) if table and "Ms" in table else ()
    runs = {(k, grid) for k in used}
    repeat = bool(runs) and runs <= _BUILT
    builds = kinds.get("build", (0, 0.0))[0]
    say("experiments_graphs", run=f"{main.__module__.rsplit('.', 1)[-1]}:{' '.join(argv)}",
        build_sets=len(used), repeats_earlier_builds=repeat,
        **{f"{k}_captured": n for k, (n, _) in sorted(kinds.items()) if n},
        **{f"{k}_capture_s": f"{s:.3f}" for k, (n, s) in sorted(kinds.items()) if n},
        retained_bytes=graphs.retained_bytes, revivals=graphs.revivals)
    if (repeat and builds) or builds > SET_KEYS_MAX * len(used):
        raise AssertionError(f"{argv}: {builds} build graphs captured on {len(used)} sets "
                             f"(every one built over this size grid before: {repeat})")
    _BUILT.update(runs)
    return dict(t=t, launches=gs.launches, ran=snnls.itrs_run, steps=opt.steps_run,
                caps=caps, cap_s=cap_s, inst_s=_instantiate_s() - inst0, reads=reads,
                out=out, table=table)


def _card_cpu_rel(card, cpu, keys, dim):
    """The largest relative difference of each metric of a deterministic
    run on the card from its ``--device cpu`` run, where the CPU's support
    is below ``dim`` (the projection's width: past it the residual is
    rounding noise)."""
    import numpy as np
    below = cpu["csizes"] < dim
    return {k: float(np.max(np.abs(card[k][below] - cpu[k][below]) / np.abs(cpu[k][below])))
            for k in keys}


def _hold_card_cpu(name, card, cpu, rel, dim, tail):
    """The same coreset sizes below ``dim``, the metrics there within
    EXP_LR_RTOL (``rel``, from ``_card_cpu_rel``), and each run's metrics
    at M_max within ``tail``'s bounds."""
    import numpy as np
    below = cpu["csizes"] < dim
    if not np.array_equal(card["csizes"][below], cpu["csizes"][below]):
        raise AssertionError(f"{name}: card and CPU coreset sizes differ below {dim}: "
                             f"{card['csizes']} against {cpu['csizes']}")
    if max(rel.values()) > EXP_LR_RTOL:
        raise AssertionError(f"{name}: card against CPU below {dim}: {rel}")
    for k, bound in tail.items():
        for where, tab in (("card", card), ("cpu", cpu)):
            if not 0.0 <= float(tab[k][-1]) <= bound:
                raise AssertionError(f"{name}: {where} {k} at M_max {float(tab[k][-1])} "
                                     f"outside [0, {bound}]")


def _exp_closed_form(torch, gs, driver, alg, extra, reduced, dim, cpu_hold=None,
                     opt_itrs=EXP_ADAM_OPT, **kv):
    """One closed-form driver run (``gaussian`` or ``linear_regression``)
    on the card, its ``[experiments]`` line and its checks: finite
    metrics, nonempty coresets at every size past 0, and by algorithm
    kernel 1 held on its select copy and one launch per iteration run
    (GIGA), no launch (SparseVI, BatchPSVI, US), the Adam steps counted
    (``opt_itrs`` a select or size) and replayed with no host read, rKL at
    M_max below EXP_RKL_FALL_CLOSED x its first size's (not BatchPSVI,
    which rebuilds at each size); with ``cpu_hold`` (the tail bounds) the same run with
    ``--device cpu``, held by ``_hold_card_cpu``.  Returns (select
    launches, the hold's score error, the coreset)."""
    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch.ops import opt

    name = f"{driver.__name__.rsplit('.', 1)[-1]}_{alg}"
    with _in_temp_dir():
        r = _drive(torch, gs, driver.main, ["--alg", alg] + extra)
    coreset, table = r["out"], r["table"]
    hilbert = isinstance(coreset, bc.HilbertCoreset)
    itr = int(coreset.snnls.state.itr) if hilbert else 0
    keys = ("rklw", "fklw", "mu_errs", "Sig_errs")
    Ms = table["Ms"]
    out = dict(Ms=",".join(str(int(m)) for m in Ms),
               csizes=",".join(str(int(c)) for c in table["csizes"]),
               rklw=",".join(f"{v:.5g}" for v in table["rklw"]),
               build_s=f"{float(table['cputs'][-1]):.3f}", iterations_run=r["ran"],
               graphs_captured=r["caps"], capture_s=f"{r['cap_s']:.3f}",
               instantiate_s=f"{r['inst_s']:.3f}")
    hold_err = 0.0
    if hilbert:
        Vsel = coreset.snnls.consts.Vsel
        hold_err = _hold_driver_select(torch, coreset, f"{name} select")
        out.update(select_held=f"{Vsel.dtype}:{tuple(Vsel.shape)}",
                   select_max_abs_err=hold_err)
    steps, reads = r["steps"], r["reads"]
    if steps:
        out.update(adam_steps=steps, adam_steps_direct=reads["direct_steps"],
                   ms_per_adam_step=f"{1e3 * float(table['cputs'][-1]) / steps:.4f}",
                   host_reads_in_adam_steps=reads["reads"],
                   host_reads_per_adam_step=f"{reads['reads'] / steps:.4f}",
                   read_sites=",".join(f"{k}*{v}" for k, v in reads["sites"].items())
                   or "none", segment=opt.SEGMENT)
    if cpu_hold is not None:
        with _in_temp_dir():
            c = _drive(torch, gs, driver.main, ["--alg", alg, "--device", "cpu"] + extra)
        rel = _card_cpu_rel(table, c["table"], keys, dim)
        out.update(cpu_seconds=f"{c['t']:.3f}",
                   cpu_csizes=",".join(str(int(v)) for v in c["table"]["csizes"]),
                   **{f"cpu_{k}_at_Mmax": f"{float(c['table'][k][-1]):.6g}" for k in keys},
                   **{f"max_rel_diff_{k}_below_{dim}": f"{v:.3g}" for k, v in rel.items()})
    _exp_line(name, r["t"], r["launches"], itr, table, keys + ("csizes",), reduced,
              **kv, **out)
    _finite_columns(table, name)
    if cpu_hold is not None:
        if c["launches"]:
            raise AssertionError(f"{name}: {c['launches']} select launches on the CPU")
        _hold_card_cpu(name, table, c["table"], rel, dim, cpu_hold)
    if not (table["csizes"][Ms > 0] > 0).all():
        raise AssertionError(f"{name}: empty coresets {table['csizes']}")
    if hilbert:
        _ran_check(name, r["launches"], r["ran"], itr, coreset.reached_numeric_limit)
    elif r["launches"]:
        raise AssertionError(f"{name}: {r['launches']} select launches")
    # the drivers' opt_itrs Adam steps per SparseVI select, per BatchPSVI size
    want = opt_itrs * {"SVI": int(Ms[-1]), "BPSVI": int((Ms > 0).sum())}.get(
        alg.split("-")[0], 0)
    if steps != want:
        raise AssertionError(f"{name}: {steps} Adam steps, expected {want}")
    if steps and reads["reads"]:
        raise AssertionError(f"{name}: {reads['reads']} host reads in the Adam steps "
                             f"({dict(reads['sites'])})")
    if steps and not r["caps"]:
        raise AssertionError(f"{name}: no graph was captured: the Adam steps did not replay")
    rkl = table["rklw"]
    if alg != "BPSVI" and not rkl[-1] < EXP_RKL_FALL_CLOSED * rkl[0]:
        raise AssertionError(f"{name}: rKL at M_max {rkl[-1]} not below "
                             f"{EXP_RKL_FALL_CLOSED} x {rkl[0]}")
    return r["launches"], hold_err, coreset


def _exp_gaussian(torch, gs):
    """The Gaussian experiment's eight algorithms at its defaults; the
    exact-family GIGA runs on data and a realistic subsample drawn on the
    CPU (the driver draws both on its device), on the card and with
    ``--device cpu``, held together.  Returns (select launches, the holds'
    largest score error)."""
    from bayesian_coresets_tpu_torch.experiments import gaussian as driver
    from bayesian_coresets_tpu_torch.models import gaussian
    from bayesian_coresets_tpu_torch.utils import prng

    cpu = torch.device("cpu")
    N, d, dim = EXP_G_N, EXP_G_D, EXP_G_PROJ
    x = gaussian.gen_synthetic(prng.fold_seed(0, 0, device=cpu), N, d)
    idx = driver.realistic_subsample(prng.fold_seed(0, 1, device=cpu), N)
    total, err = 0, 0.0
    for alg in driver.ALGS:
        exact = alg in EXP_G_EXACT
        with contextlib.ExitStack() as stack:
            if exact:
                stack.enter_context(_patched(gaussian, gen_synthetic=lambda g, n, d: x.to(
                    g.device)))
                stack.enter_context(_patched(driver, realistic_subsample=lambda g, n: idx.to(
                    g.device)))
            launches, e, _ = _exp_closed_form(
                torch, gs, driver, alg, [], "none", dim,
                cpu_hold=EXP_G_TAIL if exact else None, N=N, d=d, proj_dim=dim,
                M=EXP_G_M, data="cpu_drawn_on_both" if exact else "the_driver's_own")
        total, err = total + launches, max(err, e)
    return total, err


def _eigh_refit(torch, basis, z, w, floor):
    """The JAX package's low-rank refit, an eigh of the Gram, in f64 with
    the Gram's eigenvalues up to ``floor`` of the largest masked: with
    ``floor`` 1e-12 the port's refit before its square root, with 0 the
    yardstick of ``[linreg_refit]`` (the mask drops eigenvalues whose
    terms are not rounding: up to 1e-12 x 1e9 here).  Run directly (the
    eigh reads the host).  Returns (mu, F, the Gram's eigenvalues)."""
    x, y = z[:, :-1].double(), z[:, -1].double()
    w = w.double()
    L0inv, L0invT, r0, sigsq = (t.double() for t in basis)
    sw = torch.sqrt(torch.clamp_min(w, 0.0))
    W = (sw[:, None] * x) @ L0invT / torch.sqrt(sigsq)
    G = W @ W.T
    lam, U = torch.linalg.eigh(0.5 * (G + G.T))
    lam = torch.clamp_min(lam, 0.0)
    mask = lam > floor * torch.clamp_min(torch.max(lam), 1e-300)
    lam_safe = torch.where(mask, lam, 1.0)
    V = torch.where(mask[None, :], (W.T @ U) / torch.sqrt(lam_safe)[None, :], 0.0)
    c_inv = torch.where(mask, lam / (1.0 + lam), 0.0)
    c_half = torch.where(mask, 1.0 - 1.0 / torch.sqrt(1.0 + lam), 0.0)
    t = L0inv @ (r0 + x.T @ (w * y) / sigsq)
    t = t - V @ (c_inv * (V.T @ t))
    return L0invT @ t, L0invT - ((L0invT @ V) * c_half[None, :]) @ V.T, lam


def _linreg_refit(torch, coresets):
    """``[linreg_refit]``: the exact family's low-rank refit on the first m
    slots of SVI-EXACT's coresets, for each ``(coreset, m)`` (weights and
    points at the end of the driver's runs; the prior and noise from the
    driver's data), held to the f64 eigh form (``_eigh_refit``, mask at 0)
    and the QR posterior within LR_REFIT_TOL, with its square root's
    residual (a device value, read after the call), and the errors of the
    refit it replaced (mask at 1e-12) beside them; then its µs per call,
    20 calls in a CUDA graph, beside the replaced refit's direct µs."""
    from bayesian_coresets_tpu_torch.coresets import sparsevi
    from bayesian_coresets_tpu_torch.models import linreg

    for c, m in coresets:
        z = sparsevi._gather_pts(c.data, c._idcs[:m]).double()
        w = c._wts[:m].double()
        y = c.data[:, -1].double()
        mn, var = y.mean(), y.var(unbiased=False)
        d = z.shape[1] - 1
        mu0 = mn * torch.ones(d, dtype=torch.float64, device=z.device)
        Sig0inv = torch.eye(d, dtype=torch.float64, device=z.device) / (var + mn * mn)
        basis = linreg.lowrank_basis(mu0, Sig0inv, var)
        mu, F, res = linreg.weighted_post_lowrank(basis, z, w, residual=True)
        mu_e, F_e, lam = _eigh_refit(torch, basis, z, w, 0.0)
        mu_o, F_o, _ = _eigh_refit(torch, basis, z, w, 1e-12)
        post = linreg.weighted_post(mu0, Sig0inv, var, z, w)
        Sig_q = post.USig @ post.USig.T

        def errs(mu, F):
            return {"F_eigh": torch.linalg.norm(F - F_e) / torch.linalg.norm(F_e),
                    "Sig_qr": (F @ F.T - Sig_q).abs().max() / Sig_q.abs().max(),
                    "mu_qr": (mu - post.mu).abs().max() / post.mu.abs().max()}

        err = {k: float(v) for k, v in dict(errs(mu, F), residual=res).items()}
        old = {k: float(v) for k, v in errs(mu_o, F_o).items()}
        us = 1e3 * _graph_ms(torch, lambda stream: lambda: linreg.weighted_post_lowrank(
            basis, z, w))
        eigh_us = 1e3 * _median_ms(torch, lambda: _eigh_refit(torch, basis, z, w, 1e-12))
        # the Adam steps refit all of the coreset's slots (a power of two),
        # through this refit where they are at most d, else through the QR
        say("linreg_refit", m=z.shape[0], d=d, slots_filled=int((w > 0).sum()),
            adam_step_slots=c._cap, adam_step_refit="lowrank" if c._cap <= d else "qr",
            gram_lam_max=f"{float(lam.max()):.4g}",
            **{f"{k}_err": f"{v:.3g}" for k, v in err.items()},
            **{f"{k}_bound": f"{v:g}" for k, v in LR_REFIT_TOL.items()},
            **{f"replaced_{k}_err": f"{v:.3g}" for k, v in old.items()},
            sqrt_steps=linreg.SQRT_STEPS, us_per_call_graph=f"{us:.2f}",
            replaced_us_per_call_direct=f"{eigh_us:.2f}")
        if not all(v <= LR_REFIT_TOL[k] for k, v in err.items()):
            raise AssertionError(f"linreg_refit at m={z.shape[0]}: {err} past {LR_REFIT_TOL}")


def _exp_linear_regression(torch, gs):
    """linear_regression's seven algorithms at its defaults, SparseVI's
    sizes cut (EXP_LR_SVI_*), SVI-EXACT also at the driver's M=300 with
    its Adam steps cut (EXP_LR_FULL_OPT) and ``[linreg_refit]`` on both
    SVI-EXACT coresets; the exact-family GIGA runs on the card and
    with ``--device cpu``, held together, and kernel 1 timed on
    GIGA-OPT-EXACT's select copy (``[experiments_select]``).  Returns
    (select launches, the holds' largest score error)."""
    from bayesian_coresets_tpu_torch.experiments import linear_regression as driver
    from bayesian_coresets_tpu_torch.ops import _cuda_build

    total, err = 0, 0.0
    svi = ["--coreset_size_max", str(EXP_LR_SVI_M), "--coreset_num_sizes",
           str(EXP_LR_SVI_SIZES)]
    svi_cut = f"coreset_size_max:300->{EXP_LR_SVI_M},coreset_num_sizes:6->{EXP_LR_SVI_SIZES}"
    full = ["--coreset_size_max", "300", "--opt_itrs", str(EXP_LR_FULL_OPT)]
    exact = []
    for alg, extra, cut, kv in (("GIGA-OPT-EXACT", [], "none", {"cpu_hold": EXP_LR_TAIL}),
                                ("SVI", svi, svi_cut, {}),
                                ("SVI-EXACT", svi, svi_cut, {}),
                                ("SVI-EXACT", full, f"opt_itrs:100->{EXP_LR_FULL_OPT}",
                                 {"opt_itrs": EXP_LR_FULL_OPT}),
                                ("GIGA-OPT", [], "none", {}),
                                ("GIGA-REAL", [], "none", {}),
                                ("GIGA-REAL-EXACT", [], "none",
                                 {"cpu_hold": EXP_LR_REAL_TAIL}),
                                ("US", [], "none", {})):
        launches, e, coreset = _exp_closed_form(torch, gs, driver, alg, extra, cut, 100,
                                                N=10000, d=301, proj_dim=100, **kv)
        total, err = total + launches, max(err, e)
        if alg == "SVI-EXACT":
            exact.append((coreset, int(extra[extra.index("--coreset_size_max") + 1])))
        if alg == "GIGA-OPT-EXACT":
            # the select's time per launch on the driver's own copy (412 MB,
            # far past L2: a batch is as cold as the driver's launches)
            args = _driver_select_args(torch, coreset)
            ms, bound, _ = _time_select(torch, _cuda_build.load_library(), args,
                                        args[1].shape[0])
            Vsel = args[0]
            say("experiments_select", driver=f"linear_regression_{alg}",
                select=f"{Vsel.dtype}:{tuple(Vsel.shape)}", ms_per_launch=f"{ms:.4f}",
                bound_ms=f"{bound:.4f}", share_of_bound=f"{bound / ms:.3f}",
                ms_in_run=f"{ms * launches:.2f}")
    _linreg_refit(torch, exact)
    return total, err


def _exp_poisson(torch, gs):
    """logistic_poisson ``--model poiss`` at phase 18's logistic settings on
    ``_poisson_data``: GIGA-OPT (caching the full-data chains), GIGA-REAL,
    US, then SparseVI and BatchPSVI at sizes cut to EXP_POIS_ADAM_SIZES up
    to EXP_POIS_ADAM_M.  Returns (select launches, the holds' largest score
    error)."""
    total, err = 0, 0.0
    with _poisson_data():
        for alg in ("GIGA-OPT", "GIGA-REAL", "US"):
            launches, e = _exp_logistic(torch, gs, alg, "poiss")
            total, err = total + launches, max(err, e)
        for alg in ("SVI", "BPSVI"):
            _exp_logistic_adam(torch, gs, alg, "poiss", EXP_POIS_ADAM_M, EXP_POIS_ADAM_SIZES)
    return total, err


def phase_experiments(torch, smi):
    """The experiment drivers through their ``main([...])`` entry points,
    each in a temporary working directory; returns the select launches
    and the largest score error of the holds on the drivers' matrices."""
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps

    say("experiments", start="phase 18", card=repr(smi))
    ps.launches = 0
    with _logistic_data():
        total, err = _exp_logistic(torch, gs)
        for alg in ("SVI", "BPSVI"):
            _exp_logistic_adam(torch, gs, alg, "lr", EXP_ADAM_M, EXP_ADAM_SIZES)
        for alg in ("GIGA-REAL", "US"):
            launches, e = _exp_logistic(torch, gs, alg)
            total, err = total + launches, max(err, e)
    total += _exp_simple_lr(gs)
    for run in (_exp_synthetic_vectors, _exp_linear_regression, _exp_gaussian, _exp_poisson):
        launches, e = run(torch, gs)
        total, err = total + launches, max(err, e)
    if ps.launches:
        raise AssertionError("the experiment drivers launched the packed select kernel")
    return total, err


def _release(torch):
    """``graphs.release()`` before phases 19-20 start their ranks on this
    card: the retired graph sets and their static copies go."""
    import gc

    from bayesian_coresets_tpu_torch.ops import graphs
    gc.collect()
    torch.cuda.synchronize()
    before, retained = torch.cuda.memory_reserved(), graphs.retained_bytes
    graphs.release()
    torch.cuda.synchronize()
    say("release", retained_bytes=retained, memory_reserved_before_GB=f"{before / 1e9:.3f}",
        memory_reserved_after_GB=f"{torch.cuda.memory_reserved() / 1e9:.3f}",
        memory_allocated_GB=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    if graphs.retained_bytes or graphs._retired:
        raise AssertionError("release: retired graph sets are left")


def _rank19(part: str, d: str, cfg: dict) -> dict:
    """One rank of phase 19, spawned by ``parallel.run_local`` after phase 2
    built the kernels (the ranks load that library).  ``part`` "a": the
    1-rank group's flagship build; "b": the two ranks' build_sharded, N=1M
    stream and chain-sharded NUTS.  Returns what the parent checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.mcmc import weighted
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    dev = torch.device(cfg["dev"])
    bc.set_default_device(dev)
    mesh = P.make_mesh()
    led = mesh.ledger
    out = {"rank": mesh.rank, "backend": str(dist.get_backend())}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def per_itr(itr):
        return {k: (led.calls.get(k, 0) / itr, led.bytes.get(k, 0) / itr)
                for k in ("argmax", "row", "rows")}

    def flagship():
        """Phase 6's data and projector, from its seeds; its projection."""
        Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), cfg["N"], D_MAIN)
        proj = bc.BlackBoxProjector(_near_map_sampler, S_MAIN, logistic.log_likelihood,
                                    generator=torch.Generator(device=dev).manual_seed(1))
        return Z, proj

    def sharded_build(vecs):
        valid = torch.sqrt(torch.sum(vecs ** 2, dim=1)) > 0.0
        return P.build_sharded(vecs.T, vecs[valid].sum(dim=0), cfg["M"], mesh, valid=valid,
                               select_dtype=torch.int8, max_active=1024)

    if part == "a":
        Z, proj = flagship()
        sync()
        gs.launches = 0
        led.reset()
        t0 = time.perf_counter()
        hc = bc.HilbertCoreset(Z, proj, select_dtype=torch.int8, max_active=1024, mesh=mesh)
        sync()
        out["projection_s"] = time.perf_counter() - t0
        out["setup"] = led.totals()
        led.reset()
        t0 = time.perf_counter()
        hc.build(50)
        hc.build(cfg["M"] - 50)
        sync()
        out["build_s"] = time.perf_counter() - t0
        out["itr"], out["launches"] = int(hc.snnls.state.itr), gs.launches
        out["per_itr"] = per_itr(out["itr"])
        out["w"] = hc.snnls.weights()
        out["err"] = hc.error() / float(hc.snnls.consts.bnorm)
        gs.launches = 0
        st = sharded_build(proj.project(Z))
        out["bs_w"], out["bs_itr"], out["bs_launches"] = st.w.cpu().numpy(), int(st.itr), gs.launches
        if cfg["profile"]:
            out["profile"] = _profile_build(torch, hc.snnls.consts, "giga", "sharded_launches",
                                            comm=hc.snnls.comm)
        return out

    # part b: two ranks over gloo on one card
    Z, proj = flagship()
    vecs = proj.project(Z)
    del Z
    sync()
    gs.launches = 0
    led.reset()
    t0 = time.perf_counter()
    st = sharded_build(vecs)
    sync()
    out["bs"] = {"s": time.perf_counter() - t0, "itr": int(st.itr), "launches": gs.launches,
                 "per_itr": per_itr(int(st.itr)), "w": st.w.cpu().numpy()}
    del vecs, st

    Z1 = _host_logistic(torch, cfg["QN"], seed=100, dev=cfg["dev"])
    proj = bc.BlackBoxProjector(_near_map_sampler, S_MAIN, logistic.log_likelihood,
                                generator=torch.Generator(device=dev).manual_seed(7))
    sync()
    gs.launches = 0
    led.reset()
    t0 = time.perf_counter()
    hc = bc.HilbertCoreset(Z1, proj, stream_chunk_size=cfg["QCHUNK"], max_active=1024, mesh=mesh)
    sync()
    t_con, setup = time.perf_counter() - t0, led.totals()
    c = hc.snnls.consts
    sl = P.streamed_row_layout(cfg["QN"], mesh)[3]
    mine = c.V[:sl.stop - sl.start].cpu().numpy()
    ref = np.load(os.path.join(d, "stream_V.npy"), mmap_mode="r")[sl]
    diff = np.abs(mine.astype(np.int16) - ref.astype(np.int16))
    ref_norms = np.load(os.path.join(d, "stream_norms.npy"))[sl]
    bnorm = float(c.bnorm)
    e0 = hc.error() / bnorm
    led.reset()
    t0 = time.perf_counter()
    hc.build(cfg["M"])
    sync()
    itr = int(hc.snnls.state.itr)
    out["stream"] = {"construct_s": t_con, "setup": setup, "build_s": time.perf_counter() - t0,
                     "itr": itr, "launches": gs.launches, "per_itr": per_itr(itr),
                     "rows_differing": int((diff != 0).any(axis=1).sum()),
                     "max_int8_diff": int(diff.max()) if diff.size else 0,
                     "norms_max_rel": float(np.max(np.abs(
                         c.norms[:sl.stop - sl.start].cpu().numpy() - ref_norms) / ref_norms)),
                     "err0": e0, "err": hc.error() / bnorm,
                     "w": hc.snnls.weights()[:cfg["QN"]]}
    del hc, c, mine, ref, diff
    # the same stream at N=100k (phase 6's N), for its exchanges per iteration
    small = bc.HilbertCoreset(Z1[:cfg["N"]], proj, stream_chunk_size=cfg["QCHUNK"],
                              max_active=1024, mesh=mesh)
    led.reset()
    small.build(PROFILE_ITRS)
    out["stream_small_per_itr"] = per_itr(PROFILE_ITRS)
    del small, Z1

    with np.load(os.path.join(d, "coreset.npz")) as z:
        zc, wc = torch.as_tensor(z["pts"], device=dev), torch.as_tensor(z["wts"], device=dev)
    kw = dict(num_chains=cfg["chains"], target_accept=0.8, pooled_adaptation=True, mesh=mesh)
    _, _, r1 = weighted.run(logistic, zc, wc, 5, torch.Generator(device=dev).manual_seed(19),
                            num_warmup=1, **kw)
    led.reset()
    _, t, r = weighted.run(logistic, zc, wc, cfg["draws"],
                           torch.Generator(device=dev).manual_seed(19), num_warmup=cfg["draws"],
                           **kw)
    out["nuts"] = {"first": r1.samples.cpu().numpy(), "samples": r.samples.cpu().numpy(),
                   "divergences": int(r.num_divergent.sum()), "seconds": t,
                   "step": r.step_size.cpu().numpy(), "exchanges": led.totals()}
    return out


def phase_sharded(torch, smi, ref6, quality, wts, pts, cfg=None):
    """Phase 19: the sharded paths over ``torch.distributed`` on the one
    card, each rank a process spawned by ``parallel.run_local``: (a) a
    1-rank NCCL group; (b) two ranks over gloo.  Returns the select
    launches of its builds (every rank's)."""
    import numpy as np
    import torch.distributed as dist

    from bayesian_coresets_tpu_torch import mcmc
    from bayesian_coresets_tpu_torch.mcmc import weighted
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.parallel import run_local

    cfg = dict(SHARD_CFG if cfg is None else cfg)
    dev = torch.device(cfg["dev"])
    nccl = dist.is_nccl_available()
    say("sharded_backends", nccl_available=nccl, gloo_available=dist.is_gloo_available(),
        a=f"world=1,backend={cfg['backend_a']}", b="world=2,backend=gloo", card=repr(smi))
    if cfg["backend_a"] == "nccl" and not nccl:
        raise AssertionError("phase 19 (a): this PyTorch build has no NCCL")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "stream_V.npy"), quality["V"])
        np.save(os.path.join(d, "stream_norms.npy"), quality["norms"])
        np.savez(os.path.join(d, "coreset.npz"), wts=wts, pts=pts)
        zc, wc = torch.as_tensor(pts, device=dev), torch.as_tensor(wts, device=dev)
        _, _, r1 = weighted.run(logistic, zc, wc, 5, torch.Generator(device=dev).manual_seed(19),
                                num_chains=cfg["chains"], target_accept=0.8, num_warmup=1,
                                pooled_adaptation=True)
        first_ref = r1.samples.cpu().numpy()
        t0 = time.perf_counter()
        a = run_local(_rank19, 1, cfg["backend_a"], os.path.join(d, "init_a"),
                      args=("a", d, cfg))[0]
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = run_local(_rank19, 2, "gloo", os.path.join(d, "init_b"), args=("b", d, cfg))
        t_b = time.perf_counter() - t0

    # (a) the 1-rank group against phase 6, in this run
    same = np.array_equal(a["w"], ref6["w"])
    prof = a.get("profile", {})
    say("sharded_a", world=1, backend=a["backend"], N=cfg["N"], S=S_MAIN, itr=a["itr"],
        select_launches=a["launches"],
        select_launches_per_itr=f"{a['launches'] / max(a['itr'], 1):.3f}",
        atoms=int((a["w"] > 0).sum()), phase6_atoms=int((ref6["w"] > 0).sum()),
        weights_bit_identical_to_phase6=same, err=f"{a['err']:.6e}",
        phase6_err=f"{ref6['err']:.6e}", ms_per_itr=f"{1e3 * a['build_s'] / a['itr']:.4f}",
        phase6_ms_per_itr=f"{ref6['ms_per_itr']:.4f}",
        launches_per_itr=f"{prof.get('launches_per_itr', float('nan')):.2f}",
        phase6_launches_per_itr=f"{ref6['launches_per_itr']:.2f}",
        nccl_us_per_itr=f"{prof.get('nccl_us_per_itr', float('nan')):.1f}",
        collectives_per_itr=_per_itr_text(a["per_itr"]), projection_s=f"{a['projection_s']:.4f}",
        setup_exchanges=a["setup"], spawn_to_join_s=f"{t_a:.1f}", card=repr(smi))
    if a["itr"] != ref6["itr"] or a["launches"] != a["itr"] or not same:
        raise AssertionError(f"phase 19 (a): {a['itr']} iterations, {a['launches']} select "
                             f"launches; weights equal phase 6's: {same}")
    if a["bs_launches"] != a["bs_itr"] or a["bs_itr"] != cfg["M"]:
        raise AssertionError(f"phase 19 (a): build_sharded {a['bs_launches']} launches "
                             f"for {a['bs_itr']} iterations")

    # (b)1 build_sharded on phase 6's projection, split over two ranks
    bs = [r["bs"] for r in b]
    same_b = all(np.array_equal(x["w"], a["bs_w"]) for x in bs)
    say("sharded_b_build", world=2, backend=b[0]["backend"], N=cfg["N"], itr=bs[0]["itr"],
        select_launches=[x["launches"] for x in bs], weights_bit_identical_to_a=same_b,
        ms_per_itr=f"{1e3 * max(x['s'] for x in bs) / bs[0]['itr']:.4f}",
        collectives_per_itr=_per_itr_text(bs[0]["per_itr"]), times="gloo (copies through the host)")
    if not same_b or any(x["launches"] != x["itr"] for x in bs):
        raise AssertionError("phase 19 (b): build_sharded differs from (a) or launches != itr")

    # (b)2 the N=1M streamed-sharded build against phase 16's stream
    ss = [r["stream"] for r in b]
    differing = sum(x["rows_differing"] for x in ss)
    e_rule = max(2.0 * quality["err_in_memory"], 0.05 * quality["err0"])
    same_w = np.array_equal(ss[0]["w"], quality["w"])
    say("sharded_b_stream", N=cfg["QN"], chunk=cfg["QCHUNK"], itr=ss[0]["itr"],
        select_launches=[x["launches"] for x in ss], rows_differing=differing,
        max_int8_diff=max(x["max_int8_diff"] for x in ss),
        norms_max_rel=f"{max(x['norms_max_rel'] for x in ss):.3e}",
        err=f"{ss[0]['err']:.6e}", phase16_err=f"{quality['err']:.6e}",
        err_rule=f"{e_rule:.6e}", weights_bit_identical_to_phase16=same_w,
        construct_s=f"{max(x['construct_s'] for x in ss):.4f}",
        ms_per_itr=f"{1e3 * max(x['build_s'] for x in ss) / ss[0]['itr']:.4f}",
        collectives_per_itr=_per_itr_text(ss[0]["per_itr"]), setup_exchanges=ss[0]["setup"],
        times="gloo (copies through the host)")
    if not ss[0]["err"] < e_rule:                   # tests/test_snnls.py:279's rule
        raise AssertionError(f"phase 19 (b): streamed-sharded error/|b| {ss[0]['err']} "
                             f"against the rule {e_rule}")
    if differing == 0 and not same_w:
        raise AssertionError("phase 19 (b): no int8 row differs, but the weights differ from "
                             "phase 16's stream")
    if any(x["launches"] != x["itr"] for x in ss):
        raise AssertionError("phase 19 (b): streamed-sharded select launches != iterations")

    # (b)4 the exchanges per GIGA iteration do not depend on n: the stream's
    # at N=100k and at N=1M (its rows carry the int8 copy's 512 columns,
    # build_sharded's f32 rows phase 6's 500)
    at_100k = {k: v for k, v in b[0]["stream_small_per_itr"].items() if k != "rows"}
    at_1m = {k: v for k, v in ss[0]["per_itr"].items() if k != "rows"}
    say("sharded_collectives", N100k=_per_itr_text(at_100k), N1M=_per_itr_text(at_1m),
        equal=at_100k == at_1m)
    if at_100k != at_1m:
        raise AssertionError(f"phase 19: exchanges per iteration {at_100k} at N=100k, "
                             f"{at_1m} at N=1M")

    # (b)3 chain-sharded NUTS, 128 + 128 chains, pooled adaptation
    nu = b[0]["nuts"]
    first_err = float(np.max(np.abs(nu["first"] - first_ref)))
    samples = torch.as_tensor(nu["samples"], device=dev)
    rhat = float(mcmc.split_rhat(samples).max())
    flat = samples.reshape(-1, samples.shape[-1])
    mean, sd = flat.mean(dim=0), flat.std(dim=0)
    is_mean, is_sd, _ = _importance_moments(torch, zc, wc)
    off_is = float((torch.abs(mean.double() - is_mean) / is_sd).max())
    steps_equal = all(np.array_equal(r["nuts"]["step"], nu["step"]) for r in b)
    say("sharded_b_nuts", chains=cfg["chains"], per_rank=cfg["chains"] // 2,
        warmup=cfg["draws"], draws=cfg["draws"], first5_max_abs_diff=f"{first_err:.3e}",
        max_rhat=f"{rhat:.4f}", divergences=nu["divergences"],
        mean_minus_is_mean_sds=f"{off_is:.4f}", pooled_step_equal_on_ranks=steps_equal,
        seconds=f"{max(r['nuts']['seconds'] for r in b):.3f}", exchanges=nu["exchanges"],
        spawn_to_join_s=f"{t_b:.1f}", times="gloo (copies through the host)")
    if not first_err <= 1e-5:
        raise AssertionError(f"phase 19 (b): the first transitions differ by {first_err}")
    if rhat > RHAT_MAX or nu["divergences"] > DIV_SHARE_MAX * cfg["chains"] * cfg["draws"]:
        raise AssertionError(f"phase 19 (b): R-hat {rhat}, {nu['divergences']} divergences")
    if not off_is <= IS_SDS_MAX or not steps_equal:
        raise AssertionError(f"phase 19 (b): mean {off_is} sd from importance sampling; "
                             f"pooled steps equal on the ranks: {steps_equal}")
    return (a["launches"] + a["bs_launches"] + sum(x["launches"] for x in bs)
            + sum(x["launches"] for x in ss))


def _proj_kernels(torch):
    """Phase 20's two kernels alone, at (c)'s and (d)'s local shapes: the
    select's dots-only mode (``giga_dots``) against its plain version
    (int32 dots equal, f32 within 1e-5 of the largest), and the score of
    those dots (``giga_score_select``: the index identical, random, ties
    and all invalid, and the fused select's result bit for bit on the
    unsplit dots); each timed in a batch and cold, beside its bound and, for
    the dots, the library call that computes them.  Returns the kernels
    line's fields for both, at (c)'s shape, and the largest errors."""
    from bayesian_coresets_tpu_torch.ops import _cuda_build
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    lib = _cuda_build.load_library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    line, dots_err, score_err = {}, 0.0, 0.0
    for name, n, S in PROJ_KERNEL_SHAPES:
        dtype = getattr(torch, name)
        c, dirs = _select_problem(torch, n, S, dtype, seed=n + S)
        V, norms, valid = c.Vsel, c.norms, c.valid
        kd, pd = gs.giga_dots(V, dirs), gs.giga_dots_ref(V, dirs)
        err = float((kd.double() - pd.double()).abs().max())
        scale = float(pd.double().abs().max())
        if (dtype == torch.int8 and not torch.equal(kd, pd)) or err > 1e-5 * scale:
            raise AssertionError(f"proj dots {name} n={n}: kernel against plain {err} "
                                 f"(largest dot {scale})")
        dots_err = max(dots_err, err)
        f, e1 = _hold(gs.giga_score_select, gs.giga_score_select_ref, (kd, norms, valid),
                      f"proj score {name} n={n} random")
        fi, fs = gs.giga_select(V, dirs, norms, valid)
        ki, ks = gs.giga_score_select(kd, norms, valid)
        if (int(fi), float(fs)) != (int(ki), float(ks)):
            raise AssertionError(f"proj score {name} n={n}: ({int(ki)}, {float(ks)}) on the "
                                 f"unsplit dots, fused select ({int(fi)}, {float(fs)})")
        tied_d, tied_n = kd.clone(), norms.clone()
        first = f // 2
        for j in (first, n - 1):
            tied_d[j], tied_n[j] = kd[f], norms[f]
        _, e2 = _hold(gs.giga_score_select, gs.giga_score_select_ref, (tied_d, tied_n, valid),
                      f"proj score {name} n={n} ties", expect_idx=min(first, f))
        _hold(gs.giga_score_select, gs.giga_score_select_ref,
              (kd, norms, torch.zeros_like(valid)), f"proj score {name} n={n} all_invalid",
              expect_idx=0)
        score_err = max(score_err, e1, e2)
        del tied_d, tied_n
        # times: direct launches in a batch and cold, the plain versions, the
        # dots' library call, and the bounds
        row_bytes = V.shape[1] * V.element_size()
        out = torch.empty_like(kd)
        ws, stream = gs.workspace(V.device)
        idx = torch.empty(1, dtype=torch.int32, device="cuda")
        score = torch.empty(1, dtype=torch.float32, device="cuda")
        dl = (lib.giga_dots_launch, ptr(V), gs._DTYPE_CODE[dtype], n, row_bytes, ptr(dirs), S,
              ptr(out), ctypes.c_void_p(stream))
        sl = (lib.giga_score_launch, ptr(kd), int(dtype == torch.int8), n, ptr(norms),
              ptr(valid), ptr(ws), ptr(idx), ptr(score), ctypes.c_void_p(stream))
        times = {}
        for kname, launch, plain in (
                ("giga_dots", dl, lambda: gs.giga_dots_ref(V, dirs)),
                ("giga_score_select", sl, lambda: gs.giga_score_select_ref(kd, norms, valid))):
            times[kname] = (_direct_ms(torch, *launch), _cold_ms(torch, _launcher(*launch)),
                            _median_ms(torch, plain, batches=3, per_batch=3))
        # the score kernel's floor: an empty kernel launched by the same host
        # path with the same arguments, timed the same ways; and both kernels
        # in a CUDA graph (no host work between launches: device time)
        el = (lib.giga_empty_launch, *sl[1:])
        graph_ws = torch.zeros(2, dtype=torch.int64, device="cuda")
        floor = {"empty_kernel_ms": _direct_ms(torch, *el),
                 "empty_kernel_cold_ms": _cold_ms(torch, _launcher(*el))}
        for key, fn in (("score_graph_ms", lib.giga_score_launch),
                        ("empty_graph_ms", lib.giga_empty_launch)):
            floor[key] = _graph_ms(torch, lambda st, fn=fn: _launcher(
                fn, *sl[1:6], ptr(graph_ws), ptr(idx), ptr(score), ctypes.c_void_p(st)))
        lib_ms, lib_how = _library_ms(torch, V, dirs)
        bounds = {"giga_dots": _bound(V.numel() * V.element_size() + S * 2 * 4 + n * 2 * 4,
                                      4 * n * V.shape[1], name),
                  # 8 bytes of dots, a valid byte (and an f32 norm) a row;
                  # ~10 f32 operations a row
                  "giga_score_select": _bound(n * (9 if dtype == torch.int8 else 13) + 8,
                                              10 * n, "float32")}
        for kname in ("giga_dots", "giga_score_select"):
            k_ms, cold_ms, p_ms = times[kname]
            b_ms, b_by = bounds[kname]
            lms = lib_ms if kname == "giga_dots" else None
            say(f"proj_kernel_{kname}", dtype=name, n=n, S=S, row_bytes=row_bytes,
                kernel_ms=f"{k_ms:.4f}", cold_l2_ms=f"{cold_ms:.4f}", plain_ms=f"{p_ms:.4f}",
                bound_ms=f"{b_ms:.4f}", bound_by=b_by, share_of_bound=f"{b_ms / k_ms:.3f}",
                cold_share=f"{b_ms / cold_ms:.3f}",
                library_ms="none" if kname != "giga_dots" else
                ("not_run" if lib_ms is None else f"{lib_ms:.4f}"),
                library=lib_how if kname == "giga_dots" else "none",
                max_abs_err=dots_err if kname == "giga_dots" else score_err,
                checks=("exact_int32" if dtype == torch.int8 else "f32_1e-5") if
                kname == "giga_dots" else "random,ties,all_invalid,fused_bitwise",
                **({} if kname == "giga_dots" else
                   {k: f"{v:.4f}" for k, v in floor.items()}))
            if name == PROJ_KERNEL_SHAPES[0][0]:
                line[kname] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                               "library_ms": lms}
        del c, V, norms, valid, dirs, kd, pd, out
        torch.cuda.empty_cache()
    line["giga_dots"]["max_abs_err"] = dots_err
    line["giga_score_select"]["max_abs_err"] = score_err
    return line


def _axis_per_itr(led, itr: int) -> dict:
    """The ledger's exchanges per iteration, by axis and kind: (calls, bytes)."""
    return {a: {k: (c / itr, b / itr) for k, (c, b) in kinds.items()}
            for a, kinds in led.by_axis.items()}


def _axes_text(per_itr: dict) -> str:
    return ";".join(f"{a}:{_per_itr_text(k)}" for a, k in sorted(per_itr.items())) or "none"


def _profile_proj(torch, consts, comm, method):
    """Launches per iteration of a proj-sharded build (one rank's): 65
    iterations of warm-up, then PROFILE_ITRS under torch.profiler; the
    dots-only select kernels and the score kernels counted by name."""
    from torch.profiler import ProfilerActivity, profile

    from bayesian_coresets_tpu_torch.ops import snnls

    s = snnls.build(consts, snnls.init_state(consts, 1024), 65, 1e-6, method=method, comm=comm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s2 = snnls.build(consts, s, PROFILE_ITRS, 1e-6, method=method, comm=comm)
        torch.cuda.synchronize()
    itrs = int(s2.itr) - int(s.itr)
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda key: sum(e.count for e in rows if key in e.key)  # noqa: E731
    return {"launches_per_itr": sum(e.count for e in rows) / itrs,
            "dots_kernels_per_itr": count("giga_select") / itrs,
            "score_kernels_per_itr": count("giga_score") / itrs,
            "device_busy_us_per_itr": sum(getattr(e, "self_device_time_total", 0.0)
                                          for e in rows) / itrs}


def _rank20(part: str, d: str, cfg: dict) -> dict:
    """One rank of phase 20, spawned by ``parallel.run_local``.  ``part``
    "c": two ranks, {"proj": 2} GIGA and Frank-Wolfe at phase 6's config,
    then SparseVI and BatchPSVI on {"data": 2}; "d": four ranks, {"data": 2,
    "proj": 2} GIGA at phase 17's config, then weighted NUTS on {"data": 2,
    "chains": 2}.  Returns what the parent checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import bayesian_coresets_tpu_torch as bc
    from bayesian_coresets_tpu_torch import parallel as P
    from bayesian_coresets_tpu_torch.coresets import bpsvi, sparsevi
    from bayesian_coresets_tpu_torch.mcmc import weighted
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import snnls
    from bayesian_coresets_tpu_torch.utils import config

    dev = torch.device(cfg["dev"])
    bc.set_default_device(dev)
    out = {"rank": dist.get_rank(), "backend": str(dist.get_backend())}
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def proj_build(mesh, S, method, splits, select_dtype, tag):
        """Phase 6's data and projection at S samples, built with S split
        over the proj axis in ``splits`` as the single-process phase did."""
        Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(0), cfg["N"], D_MAIN)
        proj = bc.BlackBoxProjector(_near_map_sampler, S, logistic.log_likelihood,
                                    generator=torch.Generator(device=dev).manual_seed(1))
        # in pieces of at most 512 MB (one piece at S=500): the projection's
        # temporaries of every rank at once would not fit the card at S=16384
        step = max(1, (512 << 20) // (4 * S))
        vecs = torch.empty((Z.shape[0], S), device=dev)
        for lo in range(0, Z.shape[0], step):
            vecs[lo:lo + step] = proj.project(Z[lo:lo + step])
        valid = torch.sqrt(torch.sum(vecs ** 2, dim=1)) > 0.0
        b = vecs[valid].sum(dim=0)
        sync()
        led = mesh.ledger
        gs.launches = gs.dots_launches = gs.score_launches = 0
        led.reset()
        t0 = time.perf_counter()
        consts, n, _ = P.make_sharded_consts(vecs.T, b, mesh, valid=valid,
                                             select_dtype=select_dtype, shard_proj=True)
        del vecs, Z
        comm = P.sharded_comm(mesh, consts, True)
        sync()
        t_setup, setup = time.perf_counter() - t0, {a: dict(k) for a, k in led.by_axis.items()}
        if cuda:
            torch.cuda.empty_cache()
        state = snnls.init_state(consts, 1024)
        led.reset()
        t0 = time.perf_counter()
        for k in splits:
            state = snnls.build(consts, state, k, config.TOL, method=method, matvec_k=1024,
                                comm=comm)
        sync()
        t_build = time.perf_counter() - t0
        itr = int(state.itr)
        res = {"itr": itr, "build_s": t_build, "setup_s": t_setup, "setup": setup,
               "dots": gs.dots_launches, "score": gs.score_launches, "select": gs.launches,
               "per_itr": _axis_per_itr(led, itr), "local": tuple(consts.Vsel.shape),
               "local_dtype": str(consts.Vsel.dtype).replace("torch.", ""),
               "n_loc": consts.V.shape[0]}
        bnorm = float(consts.bnorm)
        res["err"] = float(snnls.error(consts, state.w, support=1024, comm=comm)) / bnorm
        res["w"] = comm.gather(state.w)[:n].cpu().numpy()
        res["slots"] = _slots(state)
        if cfg["profile"] and method == "giga":
            res["profile"] = _profile_proj(torch, consts, comm, method)
        if cuda:
            res["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        del consts, state
        if cuda:
            torch.cuda.empty_cache()
        out[tag] = res

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if part == "c":
        mesh = P.make_mesh({"proj": 2})
        proj_build(mesh, S_MAIN, "giga", (50, cfg["M"] - 50), torch.int8, "giga")
        proj_build(mesh, S_MAIN, "frankwolfe", (50, cfg["M"] - 50), torch.int8, "fw")
        data = P.make_mesh({"data": 2})
        sched = lambda i: 1.0 / (1.0 + i)   # noqa: E731
        for tag, N, n_sub, bb in (("canonical_exact", cfg["svi_n"], None, False),
                                  ("scaled_N100k_sub1024", cfg["svi_n_scaled"], SVI_SUB_SCALED,
                                   True)):
            x = _gaussian_data(torch, N, SVI_D, dev)
            fam = _gaussian_family(torch, SVI_D, dev, SVI_S if bb else None)
            x_loc, comm = sparsevi.data_block(x, data)
            data.ledger.reset()
            sync()
            t0 = time.perf_counter()
            w, idcs, size = sparsevi.svi_build(
                x_loc, torch.zeros(SVI_CAP, device=dev),
                torch.full((SVI_CAP,), -1, dtype=torch.int64, device=dev), 0,
                torch.Generator(device=dev).manual_seed(3), SVI_M, family=fam, n_sub_sel=n_sub,
                n_sub_opt=n_sub, opt_itrs=SVI_OPT, step_sched=sched, comm=comm)
            sync()
            out[f"svi/{tag}"] = {"s": time.perf_counter() - t0, "w": w[:size].cpu().numpy(),
                                 "idcs": idcs[:size].cpu().numpy(), "rows": x_loc.shape[0],
                                 "per_step": _axis_per_itr(data.ledger,
                                                           SVI_M * (1 + SVI_OPT))}
        x = _gaussian_data(torch, cfg["bp_n"], BP_D, dev)
        fam = _gaussian_family(torch, BP_D, dev, BP_S, grad=True)
        init = bpsvi.uniform_init_idcs(cfg["bp_n"], BP_SZ,
                                       torch.Generator(device=dev).manual_seed(9))
        x_loc, comm = sparsevi.data_block(x, data)
        data.ledger.reset()
        sync()
        t0 = time.perf_counter()
        w, p = bpsvi.bpsvi_build(x_loc, init, torch.Generator(device=dev).manual_seed(3),
                                 family=fam, n_sub_opt=cfg["bp_sub"], opt_itrs=cfg["bp_steps"],
                                 step_sched=sched, comm=comm)
        sync()
        out["bpsvi"] = {"s": time.perf_counter() - t0, "w": w.cpu().numpy(),
                        "p": p.cpu().numpy(), "per_step": _axis_per_itr(data.ledger,
                                                                         cfg["bp_steps"])}
    else:
        mesh = P.make_mesh({"data": 2, "proj": 2})
        out["coords"] = mesh.coords
        proj_build(mesh, cfg["WS"], "giga", (1, cfg["WM"] - 1), None, "giga")
        chains = P.make_mesh({"data": 2, "chains": 2})
        out["coords_chains"] = chains.coords
        with np.load(os.path.join(d, "coreset.npz")) as z:
            zc, wc = torch.as_tensor(z["pts"], device=dev), torch.as_tensor(z["wts"], device=dev)
        kw = dict(num_chains=cfg["chains"], target_accept=0.8, pooled_adaptation=True,
                  mesh=chains)
        _, _, r1 = weighted.run(logistic, zc, wc, 5, torch.Generator(device=dev).manual_seed(19),
                                num_warmup=1, **kw)
        chains.ledger.reset()
        _, t, r = weighted.run(logistic, zc, wc, cfg["draws"],
                               torch.Generator(device=dev).manual_seed(19),
                               num_warmup=cfg["draws"], **kw)
        out["nuts"] = {"first": r1.samples.cpu().numpy(), "samples": r.samples.cpu().numpy(),
                       "divergences": int(r.num_divergent.sum()), "seconds": t,
                       "step": r.step_size.cpu().numpy(),
                       "exchanges": {a: dict(k) for a, k in chains.ledger.by_axis.items()}}
    if cuda:
        out["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _against(res: dict, ref: dict, label: str) -> dict:
    """A proj-sharded build against its single-process run: the first slot
    (in the order atoms were first selected) where their atoms part, and
    the weights' and errors' distance.  Raises where the atoms agree but the
    weights do not (rtol 1e-4, atol 1e-5 of the largest), or where they part
    and the errors at M differ by more than PROJ_ERR_RTOL."""
    import numpy as np
    w, wr = res["w"], ref["w"]
    a, b = res["slots"], ref["slots"]
    k = next((i for i in range(min(a.size, b.size)) if a[i] != b[i]),
             None if a.size == b.size else min(a.size, b.size))
    scale = float(np.abs(wr).max())
    rel = float(np.max(np.abs(w - wr)) / scale)
    err_rel = abs(res["err"] - ref["err"]) / ref["err"]
    if k is None and not np.allclose(w, wr, rtol=1e-4, atol=1e-5 * scale):
        raise AssertionError(f"{label}: the same atoms, weights {rel:.3e} of the largest apart")
    if k is not None and not err_rel <= PROJ_ERR_RTOL:
        raise AssertionError(f"{label}: atoms part at slot {k}, errors {res['err']} and "
                             f"{ref['err']}")
    return dict(atoms=int((w > 0).sum()), ref_atoms=int((wr > 0).sum()),
                weights_bit_identical=bool(np.array_equal(w, wr)),
                first_parting_slot="none" if k is None else k,
                max_weight_diff_of_largest=f"{rel:.3e}", err=f"{res['err']:.6e}",
                ref_err=f"{ref['err']:.6e}", err_rel_diff=f"{err_rel:.3e}")


def phase_proj(torch, smi, ref6, ref12, ref17, wts, pts, cfg=None):
    """Phase 20: the proj axis (the select's dots-only mode and the score
    of summed dots), two-axis meshes, and SparseVI and BatchPSVI on row-
    sharded data, on the one card; ranks spawned by ``parallel.run_local``
    over gloo (NCCL refuses two ranks on one card), (c) two, (d) four.
    Returns the new kernels' launches on these paths (every rank's) and the
    kernels line's fields."""
    import numpy as np

    from bayesian_coresets_tpu_torch.coresets import bpsvi, sparsevi
    from bayesian_coresets_tpu_torch.mcmc import weighted
    from bayesian_coresets_tpu_torch.models import logistic
    from bayesian_coresets_tpu_torch.parallel import run_local

    cfg = dict(PROJ_CFG if cfg is None else cfg)
    dev = torch.device(cfg["dev"])
    say("proj_phase", start="phase 20", c="world=2,backend=gloo,{proj:2};{data:2}",
        d="world=4,backend=gloo,{data:2,proj:2};{data:2,chains:2}", card=repr(smi))
    from bayesian_coresets_tpu_torch.ops import giga_select as gs

    line = _proj_kernels(torch) if cfg["kernels"] else {}
    gs.dots_launches = gs.score_launches = 0    # the holds' launches do not count
    # the single-process runs of (c)'s SparseVI and BatchPSVI, same seeds
    sched = lambda i: 1.0 / (1.0 + i)   # noqa: E731
    refs = {}
    for tag, N, n_sub, bb in (("canonical_exact", cfg["svi_n"], None, False),
                              ("scaled_N100k_sub1024", cfg["svi_n_scaled"], SVI_SUB_SCALED,
                               True)):
        x = _gaussian_data(torch, N, SVI_D, dev)
        fam = _gaussian_family(torch, SVI_D, dev, SVI_S if bb else None)
        t0 = time.perf_counter()
        w, idcs, size = sparsevi.svi_build(
            x, torch.zeros(SVI_CAP, device=dev),
            torch.full((SVI_CAP,), -1, dtype=torch.int64, device=dev), 0,
            torch.Generator(device=dev).manual_seed(3), SVI_M, family=fam, n_sub_sel=n_sub,
            n_sub_opt=n_sub, opt_itrs=SVI_OPT, step_sched=sched)
        refs[tag] = {"w": w[:size].cpu().numpy(), "idcs": idcs[:size].cpu().numpy(),
                     "s": time.perf_counter() - t0}
    x = _gaussian_data(torch, cfg["bp_n"], BP_D, dev)
    fam = _gaussian_family(torch, BP_D, dev, BP_S, grad=True)
    init = bpsvi.uniform_init_idcs(cfg["bp_n"], BP_SZ, torch.Generator(device=dev).manual_seed(9))
    t0 = time.perf_counter()
    w, p = bpsvi.bpsvi_build(x, init, torch.Generator(device=dev).manual_seed(3), family=fam,
                             n_sub_opt=cfg["bp_sub"], opt_itrs=cfg["bp_steps"], step_sched=sched)
    refs["bpsvi"] = {"w": w.cpu().numpy(), "p": p.cpu().numpy(), "s": time.perf_counter() - t0}
    del x, fam, w, p
    zc, wc = torch.as_tensor(pts, device=dev), torch.as_tensor(wts, device=dev)
    _, _, r1 = weighted.run(logistic, zc, wc, 5, torch.Generator(device=dev).manual_seed(19),
                            num_chains=cfg["chains"], target_accept=0.8, num_warmup=1,
                            pooled_adaptation=True)
    first_ref = r1.samples.cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "coreset.npz"), wts=wts, pts=pts)
        t0 = time.perf_counter()
        c = run_local(_rank20, 2, "gloo", os.path.join(d, "init_c"), args=("c", d, cfg))
        t_c = time.perf_counter() - t0
        launches = {"giga_dots": 0, "giga_score_select": 0}
        _proj_builds(c, "c", (("giga", ref6), ("fw", ref12)), cfg["N"], cfg, launches, smi)
        _proj_svi(c, refs, cfg)
        say("proj_c_spawn", spawn_to_join_s=f"{t_c:.1f}",
            peak_GB_by_rank=[f"{r.get('peak_GB', float('nan')):.3f}" for r in c])
        t0 = time.perf_counter()
        dd = run_local(_rank20, 4, "gloo", os.path.join(d, "init_d"), args=("d", d, cfg))
        t_d = time.perf_counter() - t0
    _proj_builds(dd, "d", (("giga", ref17),), -(-cfg["N"] // 2), cfg, launches, smi)
    if [r["coords"] for r in dd] != [{"data": k // 2, "proj": k % 2} for k in range(4)] or \
            [r["coords_chains"] for r in dd] != [{"data": k // 2, "chains": k % 2}
                                                 for k in range(4)]:
        raise AssertionError(f"phase 20 (d): coordinates {[r['coords'] for r in dd]}")
    _proj_nuts(torch, dd, first_ref, zc, wc, cfg)
    say("proj_d_spawn", spawn_to_join_s=f"{t_d:.1f}",
        peak_GB_by_rank=[f"{r.get('peak_GB', float('nan')):.3f}" for r in dd], launches=launches)
    return launches, line


def _proj_builds(ranks, part, builds, n_loc, cfg, launches, smi):
    """Phase 20's proj-sharded builds of one spawn against their single-
    process phases; adds the ranks' kernel launches to ``launches``."""
    import numpy as np

    for tag, ref in builds:
        res = [r[tag] for r in ranks]
        r0 = res[0]
        label = f"phase 20 ({part}) {tag}"
        cmp = _against(r0, ref, label)
        for r in res[1:]:
            if not np.array_equal(r["w"], r0["w"]):
                raise AssertionError(f"{label}: the ranks' weights differ")
        prof = r0.get("profile", {})
        say(f"proj_{part}_{tag}", world=len(ranks), local_block=r0["local"],
            local_dtype=r0["local_dtype"], itr=r0["itr"],
            dots_launches=[r["dots"] for r in res], score_launches=[r["score"] for r in res],
            fused_select_launches=[r["select"] for r in res],
            select_launches_per_itr=f"{(r0['dots'] + r0['score']) / r0['itr']:.3f}",
            ms_per_itr=f"{1e3 * max(r['build_s'] for r in res) / r0['itr']:.4f}",
            ref_ms_per_itr=f"{ref['ms_per_itr']:.4f}",
            setup_s=f"{max(r['setup_s'] for r in res):.4f}",
            launches_per_itr=f"{prof.get('launches_per_itr', float('nan')):.2f}",
            dots_kernels_per_itr=f"{prof.get('dots_kernels_per_itr', float('nan')):.3f}",
            score_kernels_per_itr=f"{prof.get('score_kernels_per_itr', float('nan')):.3f}",
            device_busy_us_per_itr=f"{prof.get('device_busy_us_per_itr', float('nan')):.1f}",
            exchanges_per_itr=_axes_text(r0["per_itr"]),
            peak_GB=[f"{r.get('peak_GB', float('nan')):.3f}" for r in res], **cmp,
            times="gloo (copies through the host)", card=repr(smi))
        want = cfg["M"] if part == "c" else cfg["WM"]
        if any(r["itr"] != want or r["dots"] != r["itr"] or r["score"] != r["itr"]
               or r["select"] for r in res):
            raise AssertionError(f"{label}: {[(r['itr'], r['dots'], r['score'], r['select']) for r in res]} "
                                 "(iterations, dots, score and fused select launches)")
        dots_c, dots_b = r0["per_itr"]["proj"]["dots"]
        if dots_c != 1 or dots_b != r0["n_loc"] * 2 * 4 or r0["n_loc"] != n_loc:
            raise AssertionError(f"{label}: proj dots exchanges {dots_c}/{dots_b} B per "
                                 f"iteration for {r0['n_loc']} local rows")
        if prof and (prof["dots_kernels_per_itr"] != 1 or prof["score_kernels_per_itr"] != 1):
            raise AssertionError(f"{label}: profiled {prof}")
        launches["giga_dots"] += sum(r["dots"] for r in res)
        launches["giga_score_select"] += sum(r["score"] for r in res)


def _proj_svi(c, refs, cfg):
    """Phase 20 (c)'s SparseVI and BatchPSVI on {"data": 2} against one
    process."""
    import numpy as np

    for tag in ("canonical_exact", "scaled_N100k_sub1024"):
        res, ref = [r[f"svi/{tag}"] for r in c], refs[tag]
        same = all(np.array_equal(r["idcs"], ref["idcs"]) for r in res)
        scale = float(np.abs(ref["w"]).max())
        rel = max(float(np.max(np.abs(r["w"] - ref["w"]))) for r in res) / scale
        say("proj_c_svi", arm=tag, world=2, rows=[r["rows"] for r in res], size=ref["idcs"].size,
            idcs_identical=same, max_weight_diff_of_largest=f"{rel:.3e}",
            s=f"{max(r['s'] for r in res):.4f}", ref_s=f"{ref['s']:.4f}",
            us_per_adam_step=f"{1e6 * max(r['s'] for r in res) / (SVI_M * (1 + SVI_OPT)):.2f}",
            exchanges_per_adam_step=_axes_text(res[0]["per_step"]),
            times="gloo (copies through the host)")
        if not same or not all(np.allclose(r["w"], ref["w"], rtol=SVI_SHARD_RTOL,
                                           atol=1e-6 * scale) for r in res):
            raise AssertionError(f"phase 20 (c) svi {tag}: indices equal {same}, weights "
                                 f"{rel:.3e} of the largest apart")
    res, ref = [r["bpsvi"] for r in c], refs["bpsvi"]
    dw = max(float(np.max(np.abs(r["w"] - ref["w"]))) for r in res)
    dp = max(float(np.max(np.abs(r["p"] - ref["p"]))) for r in res)
    say("proj_c_bpsvi", world=2, N=cfg["bp_n"], sz=BP_SZ, n_sub=cfg["bp_sub"], steps=cfg["bp_steps"],
        max_weight_diff=f"{dw:.3e}", max_point_diff=f"{dp:.3e}",
        s=f"{max(r['s'] for r in res):.4f}", ref_s=f"{ref['s']:.4f}",
        us_per_joint_step=f"{1e6 * max(r['s'] for r in res) / cfg['bp_steps']:.2f}",
        exchanges_per_joint_step=_axes_text(res[0]["per_step"]),
        times="gloo (copies through the host)")
    for r in res:
        if not (np.allclose(r["w"], ref["w"], rtol=SVI_SHARD_RTOL,
                            atol=SVI_SHARD_RTOL * float(np.abs(ref["w"]).max()))
                and np.allclose(r["p"], ref["p"], rtol=SVI_SHARD_RTOL, atol=SVI_SHARD_RTOL)):
            raise AssertionError(f"phase 20 (c) bpsvi: weights {dw}, points {dp} apart")


def _proj_nuts(torch, dd, first_ref, zc, wc, cfg):
    """Phase 20 (d)'s chain-sharded NUTS on {"data": 2, "chains": 2}: phase
    19's checks, and every rank's draws the same."""
    import numpy as np
    from bayesian_coresets_tpu_torch import mcmc

    dev = zc.device
    nu = dd[0]["nuts"]
    first_err = float(np.max(np.abs(nu["first"] - first_ref)))
    samples = torch.as_tensor(nu["samples"], device=dev)
    rhat = float(mcmc.split_rhat(samples).max())
    flat = samples.reshape(-1, samples.shape[-1])
    is_mean, is_sd, _ = _importance_moments(torch, zc, wc)
    off_is = float((torch.abs(flat.mean(dim=0).double() - is_mean) / is_sd).max())
    steps_equal = all(np.array_equal(r["nuts"]["step"], nu["step"]) for r in dd)
    same_draws = all(np.array_equal(r["nuts"]["samples"], nu["samples"]) for r in dd)
    say("proj_d_nuts", mesh="{data:2,chains:2}", chains=cfg["chains"],
        per_chain_rank=cfg["chains"] // 2, warmup=cfg["draws"], draws=cfg["draws"],
        first5_max_abs_diff=f"{first_err:.3e}", max_rhat=f"{rhat:.4f}",
        divergences=nu["divergences"], mean_minus_is_mean_sds=f"{off_is:.4f}",
        pooled_step_equal_on_ranks=steps_equal, draws_equal_on_ranks=same_draws,
        seconds=f"{max(r['nuts']['seconds'] for r in dd):.3f}",
        exchanges={a: {k: v[0] for k, v in kinds.items()} for a, kinds in nu["exchanges"].items()},
        times="gloo (copies through the host)")
    if not first_err <= 1e-5:
        raise AssertionError(f"phase 20 (d): the first transitions differ by {first_err}")
    if rhat > RHAT_MAX or nu["divergences"] > DIV_SHARE_MAX * cfg["chains"] * cfg["draws"]:
        raise AssertionError(f"phase 20 (d): R-hat {rhat}, {nu['divergences']} divergences")
    if not off_is <= IS_SDS_MAX or not steps_equal or not same_draws:
        raise AssertionError(f"phase 20 (d): mean {off_is} sd from importance sampling; "
                             f"steps equal {steps_equal}, draws equal {same_draws}")


def _per_itr_text(per_itr: dict) -> str:
    """kind:calls/bytes per iteration, for a say() line."""
    return ",".join(f"{k}:{c:g}/{n:g}B" for k, (c, n) in sorted(per_itr.items()))


def main() -> int:
    import torch   # noqa: F401  (fails here without PyTorch)

    if not (ROOT / "bayesian_coresets_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(bayesian_coresets_tpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    max_err, (k_ms, p_ms, k_bound, k_bound_by, k_lib) = phase_select(torch)
    packed_launches, packed_err, pk_ms, pp_ms, pk_bound, pk_bound_by = phase_packed(torch)
    phase_build_parity(torch)
    from bayesian_coresets_tpu_torch.ops import giga_select as gs
    from bayesian_coresets_tpu_torch.ops import packed_select as ps
    gs.launches = ps.launches = 0
    launches, wts, pts, coreset, Z, projector, ref6, (rebuilt, rb_launches) = \
        phase_main(torch, smi)
    if ps.launches:
        raise AssertionError("main path: the packed select kernel was launched")
    gs.launches = ps.launches = 0
    phase_nuts(torch, smi, wts, pts)
    say("nuts_launches", giga_select=gs.launches, packed_select=ps.launches)
    gs.launches = ps.launches = 0
    phase_optimize(torch, coreset, rebuilt)
    del rebuilt, coreset
    regrid_launches = _main_regrid(torch, smi, Z)
    phase_svi(torch, smi)
    phase_svi_parity(torch)
    phase_bpsvi(torch, smi)
    say("svi_bpsvi_optimize_launches", giga_select=gs.launches, packed_select=ps.launches)
    fw_launches, ref12 = phase_frankwolfe(torch, smi, Z, projector)
    omp_launches = phase_omp(torch, smi, Z, projector)
    phase_sampling(torch, smi, Z, projector)
    del Z, projector
    torch.cuda.empty_cache()
    pois_launches = phase_poisson(torch, smi)
    gs.launches = 0
    st_launches, stq_launches, st_omp_launches, st_select, quality = phase_streamed(torch, smi)
    gs.launches = 0
    wide_launches, ref17 = phase_wide_build(torch, smi)
    torch.cuda.empty_cache()
    exp_launches, exp_err = phase_experiments(torch, smi)
    gs.launches = ps.launches = 0
    _release(torch)
    sharded_launches = phase_sharded(torch, smi, ref6, quality, wts, pts)
    gs.dots_launches = gs.score_launches = 0
    proj_launches, proj_line = phase_proj(torch, smi, ref6, ref12, ref17, wts, pts)
    if gs.dots_launches != 0 or gs.score_launches != 0:
        raise AssertionError("phase 20's parent launched a proj kernel outside its ranks' "
                             "count: the kernels line takes the ranks' counts")
    if ps.launches:
        raise AssertionError("a solver's path launched the packed select kernel")
    say("select_launches_by_path", giga=launches, giga_rebuild=rb_launches,
        giga_regrid=regrid_launches,
        frankwolfe=fw_launches, omp=omp_launches,
        sampling=0, poisson_giga=pois_launches, streamed_giga_N8M=st_launches,
        quality_arms_N1M=stq_launches, streamed_omp_N1M=st_omp_launches,
        streamed_sampling_N1M=0, wide_giga_fw_S16384=wide_launches,
        experiments=exp_launches, sharded_ranks=sharded_launches)
    launches += (rb_launches + regrid_launches + fw_launches + omp_launches + pois_launches
                 + st_launches
                 + stq_launches
                 + st_omp_launches + wide_launches + exp_launches + sharded_launches)
    max_err = max(max_err, st_select[5], exp_err)
    from bayesian_coresets_tpu_torch import native
    if any(m.split(".")[0] in ("jax", "bayesian_coresets_tpu") for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    if any(m.split(".")[0] in ("pandas", "matplotlib") for m in sys.modules):
        raise AssertionError("the port imported pandas or matplotlib")
    if not native.SOURCE.resolve().is_relative_to(ROOT / "bayesian_coresets_tpu_torch"):
        raise AssertionError(f"the port builds from {native.SOURCE}, outside its package")
    say("elapsed", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": "giga_select", "route": "cuda",
         "source": "bayesian_coresets_tpu_torch/csrc/giga_select.cu",
         "replaces": "bayesian_coresets_tpu/ops/pallas_kernels.py:110",
         "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k_bound, "bound_by": k_bound_by, "library_ms": k_lib},
        {"name": "packed_select", "route": "cuda",
         "source": "bayesian_coresets_tpu_torch/csrc/packed_select.cu",
         "replaces": "scripts/probe_int4_pallas.py:73",
         "launches": packed_launches, "max_abs_err": packed_err, "ms": pk_ms,
         "plain_ms": pp_ms, "bound_ms": pk_bound, "bound_by": pk_bound_by,
         "library_ms": None}] + [
        {"name": name, "route": "cuda",
         "source": "bayesian_coresets_tpu_torch/csrc/giga_select.cu",
         "replaces": "bayesian_coresets_tpu/ops/pallas_kernels.py:110",
         "launches": proj_launches[name], **proj_line[name]}
        for name in ("giga_dots", "giga_score_select")] + [
        {"name": "fold_scale", "route": "cuda",
         "source": "bayesian_coresets_tpu_torch/csrc/fold_scale.cu",
         "replaces": "bayesian_coresets_tpu/ops/snnls.py:698",
         "launches": ref6["fold_launches"], "max_abs_err": 0.0,
         "ms": ref6["fold"]["ms"], "plain_ms": ref6["fold"]["plain_ms"],
         "bound_ms": ref6["fold"]["bound_ms"], "bound_by": ref6["fold"]["bound_by"],
         "library_ms": None}] + [
        {"name": f"giga_step_{name}", "route": "cuda",
         "source": "bayesian_coresets_tpu_torch/csrc/giga_step.cu",
         "replaces": "bayesian_coresets_tpu/ops/snnls.py:580",
         "launches": FUSED_LAUNCHES[name], "max_abs_err": 0.0,
         "ms": ref6["giga_step"][name]["ms"], "plain_ms": ref6["giga_step"][name]["plain_ms"],
         "bound_ms": ref6["giga_step"][name]["bound_ms"],
         "bound_by": ref6["giga_step"][name]["bound_by"], "library_ms": None}
        for name in ("update", "dirs")]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
