"""CUDA-only checks of the PyTorch port: the hand-written select kernels
(GIGA's and the packed-int4 probe's) against their plain PyTorch versions
(directions on the int8 rounding boundaries, row counts below and off the
tile size, 100 calls back to back on one workspace, two streams, one
launch per select, rows past the ring kernels' width through the wide-row
kernels, narrow and wide calls in turn), numpy data landing on the card,
GIGA, Frank-Wolfe and OMP builds on the card against the same builds on the
CPU, sampling builds that read only ``done``, a short
NUTS run on the card, projected Adam, SparseVI and ``optimize()`` on the
card against the CPU, SparseVI and BatchPSVI builds that read nothing
back from the card but SparseVI's one flag per select, and the
synthetic_vectors experiment driver on the card against ``--device cpu``;
the proj axis's two kernels (the select's dots-only mode and the score of
summed dots) against their plain versions and against the fused select;
rows of 4-48 KB (past the ring kernel's limit) through the select and its
dots-only mode at every dtype, and the score kernel at row counts off its
block and grid, on views off 16-byte alignment, with ties at the first
and last rows and 100 calls back to back; builds, NUTS and SparseVI's and
BatchPSVI's Adam steps replayed as CUDA graphs against their direct runs,
bit for bit (the Adam steps on the exact, basis, logistic warm-Laplace and
linear-regression black-box families, tails, resumed builds), a capture
that raises on a host read, posterior refits that read nothing, builds
and re-solves on new constants of one shape that replay the graph sets of
the first (each its own one-iteration build bit for bit), builds walked
over a driver's log grid of sizes that capture at most 14 graphs and then
none, a layout whose constants all died revived without a capture,
generators alternating through one sampling set, retired sets evicted
past their budget and released, and the
``logistic_poisson --model poiss`` and ``linear_regression`` drivers'
Adam steps replayed with no host read; and the fused GIGA step's two
kernels (``ops/giga_step.py``) against their plain versions on the states
that decide each branch, replayed builds on them against the CPU's, the
graph nodes of a replayed iteration (at most 4) and their launch counts.

Every test here needs a card and skips without one.  This file imports no
JAX, so it also runs where JAX is absent; there, skip the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import gc
import time
import warnings

import numpy as np
import pytest
import torch

import bayesian_coresets_tpu_torch as bc
from bayesian_coresets_tpu_torch import mcmc
from bayesian_coresets_tpu_torch.coresets import bpsvi, sparsevi
from bayesian_coresets_tpu_torch.mcmc import integrators, nuts
from bayesian_coresets_tpu_torch.models import gaussian
import giga_step_cases as gsc
from bayesian_coresets_tpu_torch.ops import giga_select as gs
from bayesian_coresets_tpu_torch.ops import giga_step as gst
from bayesian_coresets_tpu_torch.ops import graphs
from bayesian_coresets_tpu_torch.ops import packed_select as ps
from bayesian_coresets_tpu_torch.ops import snnls
from bayesian_coresets_tpu_torch.ops.opt import nn_opt
from bayesian_coresets_tpu_torch.utils import interop
from tiny_data import write_poisson

torch.set_num_threads(1)

DTYPES = [torch.int8, torch.bfloat16, torch.float32]
CASES = ["random", "invalid_block", "all_invalid", "ties"]


@pytest.fixture
def cuda_device():
    """The card, with no graph set retired by an earlier test (a set now
    outlives its constants)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU route)")
    gc.collect()
    graphs.release()
    return torch.device("cuda")


def _select_inputs(case, dtype, n=5000, S=500, seed=0):
    """CPU tensors (Vsel, dirs, norms, valid) shaped as make_consts makes them."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "invalid_block":
        valid[n // 2:] = False
    elif case == "all_invalid":
        valid[:] = False
    elif case == "ties":
        A[:, [7, 2000, n - 1]] = A[:, [2000]]
    c = snnls.make_consts(torch.as_tensor(A), torch.as_tensor(A.sum(axis=1)),
                          valid=torch.as_tensor(valid), select_dtype=dtype)
    dirs = rng.normal(size=(S, 2)).astype(np.float32)
    dirs[:, 1] -= dirs[:, 0] * (dirs[:, 0] @ dirs[:, 1]) / (dirs[:, 0] @ dirs[:, 0])
    dirs /= np.linalg.norm(dirs, axis=0)
    if case == "ties":
        dirs[:, 0] = A[:, 2000] / np.linalg.norm(A[:, 2000])   # row 2000's copies win
    return c.Vsel, torch.as_tensor(dirs), c.norms, c.valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain(dtype, case, cuda_device):
    args = [t.to(cuda_device) for t in _select_inputs(case, dtype)]
    before = gs.launches
    ki, ks = gs.giga_select(*args)
    torch.cuda.synchronize()
    assert gs.launches == before + 1
    pi, ps = gs.giga_select_ref(*args)
    assert int(ki) == int(pi)
    if case == "all_invalid":
        assert int(ki) == 0 and float(ks) == -np.inf
    else:
        np.testing.assert_allclose(float(ks), float(ps), rtol=1e-6)
    if case == "ties":
        assert int(ki) == 7


@pytest.mark.cuda
def test_build_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(1)
    A = rng.normal(size=(256, 3000)).astype(np.float32)
    c_cpu = snnls.make_consts(torch.as_tensor(A), torch.as_tensor(A.sum(axis=1)),
                              select_dtype=torch.int8)
    c_gpu = interop.snnls_consts(type(c_cpu)(*(t.numpy() for t in c_cpu)), cuda_device)
    s_cpu = snnls.build(c_cpu, snnls.init_state(c_cpu, 1024), 150, 1e-6)
    before = gs.launches
    s_gpu = snnls.build(c_gpu, snnls.init_state(c_gpu, 1024), 150, 1e-6)
    assert gs.launches - before == int(s_gpu.itr)
    k = int(s_cpu.size)
    assert int(s_gpu.size) == k
    np.testing.assert_array_equal(s_gpu.idcs[:k].cpu().numpy(), s_cpu.idcs[:k].numpy())
    np.testing.assert_allclose(s_gpu.w.cpu().numpy(), s_cpu.w.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("method,itrs,rtol", [("frankwolfe", 150, 1e-4), ("orthopursuit", 25, 1e-3)])
def test_solver_build_on_card_matches_cpu(method, itrs, rtol, cuda_device):
    """Frank-Wolfe and OMP select through the kernel on the card and through
    the plain version on the CPU: the same atoms, one launch per iteration.
    OMP's weights pass 256 f32 FISTA steps per iteration on each device."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(256, 3000)).astype(np.float32)
    c_cpu = snnls.make_consts(torch.as_tensor(A), torch.as_tensor(A.sum(axis=1)),
                              select_dtype=torch.int8)
    c_gpu = interop.snnls_consts(type(c_cpu)(*(t.numpy() for t in c_cpu)), cuda_device)
    s_cpu = snnls.build(c_cpu, snnls.init_state(c_cpu, 256), itrs, 1e-6, method=method)
    before = gs.launches
    s_gpu = snnls.build(c_gpu, snnls.init_state(c_gpu, 256), itrs, 1e-6, method=method)
    assert gs.launches - before == int(s_gpu.itr) == itrs
    k = int(s_cpu.size)
    assert int(s_gpu.size) == k and not bool(s_gpu.done)
    np.testing.assert_array_equal(s_gpu.idcs[:k].cpu().numpy(), s_cpu.idcs[:k].numpy())
    np.testing.assert_allclose(s_gpu.w.cpu().numpy(), s_cpu.w.numpy(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["importance", "uniform"])
def test_sampling_build_reads_only_done(method, cuda_device):
    """A sampling build in one-iteration segments launches no select kernel
    and reads one pair per draw (``itr`` and ``done``, which a support
    overflow latches) and nothing else in the loop; without support slots
    it reads nothing in the loop at all (replayed segments:
    test_replayed_build_reads_once_per_segment)."""
    rng = np.random.default_rng(2)
    A = torch.as_tensor(rng.normal(size=(64, 2000)).astype(np.float32), device=cuda_device)
    c = snnls.make_consts(A, A.sum(dim=1), sampling=method)
    assert c.ps.is_cuda
    before = gs.launches
    for K, per_draw in ((512, 1), (0, 0)):
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        s, syncs = _syncs(lambda: snnls.build(c, snnls.init_state(c, K), 80, 1e-6,
                                              method=method, draws=gen, segment=1))
        in_loop = [x for x in syncs if "ops/snnls.py" in x]
        # outside the loop: the state's itr and done on entry
        assert len(in_loop) - 80 * per_draw <= 4, syncs
        assert len(in_loop) == len(syncs)
        assert s.w.is_cuda and float(s.cts.sum()) == 80 and bool((s.w >= 0).all())
        np.testing.assert_allclose((A @ s.w).cpu().numpy(), s.xw.cpu().numpy(),
                                   rtol=1e-3, atol=1e-3)
    assert gs.launches == before


PACKED_CASES = ["random", "invalid_block", "ties", "all_invalid", "odd_rows", "unpadded_cols"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_kernel_matches_plain(case, cuda_device):
    n, S = (4999 if case == "odd_rows" else 5120), (100 if case == "unpadded_cols" else 512)
    rng = np.random.default_rng(2)
    q = rng.integers(-7, 8, size=(n, S)).astype(np.int8)
    dirs = rng.uniform(-0.04, 0.04, size=(S, 2)).astype(np.float32)
    nrminv = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    bias = np.zeros(n, np.float32)
    P = ps.pack_int4(torch.as_tensor(q))
    args = [P, torch.as_tensor(dirs), torch.as_tensor(nrminv), torch.as_tensor(bias)]
    f = int(ps.packed_select_ref(*args)[0])
    if case == "invalid_block":
        args[3][f // 1024 * 1024: f // 1024 * 1024 + 1024] = -np.inf
    elif case == "ties":
        for j in (f // 2, n - 1):
            args[0][j], args[2][j] = args[0][f], args[2][f]
    elif case == "all_invalid":
        args[3][:] = -np.inf
    args = [t.to(cuda_device) for t in args]
    before = ps.launches
    ki, ks = ps.packed_select(*args)
    torch.cuda.synchronize()
    assert ps.launches == before + 1
    pi, pscore = ps.packed_select_ref(*args)
    assert int(ki) == int(pi)
    if case == "all_invalid":
        assert int(ki) == 0 and float(ks) == -np.inf
    else:
        np.testing.assert_allclose(float(ks), float(pscore), rtol=1e-6)
    if case == "ties":
        assert int(ki) == f // 2


def _boundary_dirs(rng, S):
    """(S, 2) f32 directions d with 127 d exactly on a half integer in f32
    (+-0.5, +-1.5, +-2.5), so the in-kernel int8 quantization must round
    half to even to match the plain version."""
    k = rng.integers(-3, 3, size=(S, 2)).astype(np.float32) + np.float32(0.5)
    d = (k / np.float32(127.0)).astype(np.float32)
    for cand in (np.nextafter(d, np.float32(np.inf)), np.nextafter(d, np.float32(-np.inf))):
        off = (d * np.float32(127.0)).astype(np.float32) != k
        d[off] = cand[off]
    assert ((d * np.float32(127.0)).astype(np.float32) == k).all()
    return torch.as_tensor(d)


def _giga_inputs(dtype, n, S=500, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    c = snnls.make_consts(torch.as_tensor(A), torch.as_tensor(A.sum(axis=1)),
                          select_dtype=dtype)
    dirs = rng.normal(size=(S, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=0)
    return [c.Vsel, torch.as_tensor(dirs), c.norms, c.valid]


def _packed_inputs(n, S=512, seed=4):
    rng = np.random.default_rng(seed)
    P = ps.pack_int4(torch.as_tensor(rng.integers(-7, 8, size=(n, S)).astype(np.int8)))
    dirs = torch.as_tensor(rng.uniform(-0.04, 0.04, size=(S, 2)).astype(np.float32))
    nrminv = torch.as_tensor(rng.uniform(0.5, 2.0, size=n).astype(np.float32))
    return [P, dirs, nrminv, torch.zeros(n)]


KERNELS = {"giga": (gs.giga_select, gs.giga_select_ref),
           "packed": (ps.packed_select, ps.packed_select_ref)}


def _hold(kind, args):
    kernel, plain = KERNELS[kind]
    ki, ks = kernel(*args)
    pi, pscore = plain(*args)
    assert int(ki) == int(pi)
    if float(pscore) == -np.inf:
        assert float(ks) == -np.inf
    else:
        np.testing.assert_allclose(float(ks), float(pscore), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "packed"])
def test_in_kernel_quantization_rounds_half_to_even(kind, cuda_device):
    rng = np.random.default_rng(5)
    if kind == "int8":
        args = _giga_inputs(torch.int8, 3000)
        args[1] = _boundary_dirs(rng, 500)
        _hold("giga", [t.to(cuda_device) for t in args])
    else:
        args = _packed_inputs(3000)
        args[1] = _boundary_dirs(rng, 512)
        _hold("packed", [t.to(cuda_device) for t in args])


# int8 rows of 512 B fill 8 KB tiles with 16 rows (bf16 8, f32 4): n=1 and
# 7 are below one tile, 129 and 5003 are off the tile size with a ragged
# last tile
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 129, 5003])
@pytest.mark.parametrize("dtype", DTYPES + ["packed"])
def test_kernel_row_counts(dtype, n, cuda_device):
    if dtype == "packed":
        _hold("packed", [t.to(cuda_device) for t in _packed_inputs(n)])
    else:
        _hold("giga", [t.to(cuda_device) for t in _giga_inputs(dtype, n)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["giga", "packed"])
def test_back_to_back_calls_reuse_the_workspace(kind, cuda_device):
    """100 calls on one stream with no reset between them, an all-invalid
    call among them: each takes the key and ticket the last one left zero."""
    args = (_giga_inputs(torch.int8, 20000) if kind == "giga"
            else _packed_inputs(20000))
    args = [t.to(cuda_device) for t in args]
    kernel, plain = KERNELS[kind]
    dirs = [args[1] * (1.0 + 0.05 * k) + 0.01 * k for k in range(5)]
    want = [int(plain(args[0], d, *args[2:])[0]) for d in dirs]
    dead = (torch.zeros_like(args[3]) if kind == "giga"
            else torch.full_like(args[3], -np.inf))
    got, dead_out = [], None
    for r in range(100):
        if r == 50:
            dead_out = kernel(args[0], args[1], args[2], dead)
        got.append(kernel(args[0], dirs[r % 5], *args[2:])[0])
    torch.cuda.synchronize()
    assert [int(g) for g in got] == [want[r % 5] for r in range(100)]
    assert int(dead_out[0]) == 0 and float(dead_out[1]) == -np.inf


# Rows past the ring kernels' 48 KB (packed 32 KB) take the wide-row kernels,
# which walk groups of 8 rows in 4 KB pieces: (kind, S, n, rows of dirs or
# None for S).  "packed" counts original columns: 65568 is a 32784-byte row.
# On the H100 a block keeps the whole row's quantized directions in shared
# memory up to 65984-byte rows (f32 S=16496; packed 32992 bytes, S=65984);
# past that every group fetches them again.
WIDE = [
    # the first widths past the limit for each type, and f32 well past it;
    # n=2051 is off every group of 8 rows
    ("float32", 12289, 2051, None), ("float32", 16384, 2051, None),
    ("bfloat16", 24584, 2051, None), ("int8", 49168, 2051, None), ("packed", 65568, 2051, None),
    # fewer rows than the card has SMs
    ("float32", 12289, 1, None), ("int8", 49168, 7, None), ("bfloat16", 24584, 131, None),
    ("packed", 65568, 131, None),
    # the widest rows whose directions stay in shared memory, and 16 bytes past
    ("float32", 16496, 131, None), ("float32", 16500, 131, None),
    ("packed", 65984, 131, None), ("packed", 66016, 131, None),
    # rows of exactly 32 pieces (16 packed), and 16 bytes past: a last piece
    # of one chunk
    ("float32", 32768, 67, None), ("float32", 32772, 67, None),
    ("packed", 131072, 67, None), ("packed", 131104, 67, None),
    # S < Sp: zero-padded columns inside the last piece (32773 -> Sp 32776;
    # packed 131080 -> 65552 bytes), and directions that end at column
    # 20000, so the pieces past it see zero directions
    ("float32", 32773, 67, None), ("packed", 131080, 67, None), ("float32", 32776, 67, 20000),
    # the widest row the entry points take: 1 MiB, 256 pieces
    ("float32", 262144, 64, None),
]
WIDE_IDS = [f"{k}-{S}-n{n}" + (f"-dirs{d}" if d else "") for k, S, n, d in WIDE]
# f32 and bf16 sums of up to 262144 products, taken in another order than
# the plain matmul's; int8 and packed dots are integers, exact
WIDE_RTOL = {"float32": 1e-6, "bfloat16": 1e-6, "int8": 0.0, "packed": 0.0}


def _wide_inputs(kind, S, dev, n=2051, seed=11, dirs_S=None):
    """Inputs of a wide-row select, made on ``dev``; with ``dirs_S``, only
    the first dirs_S columns of the directions are given (the rest are zero)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "packed":
        q = torch.randint(-7, 8, (n, S), generator=gen, device=dev, dtype=torch.int8)
        dirs = torch.rand((S, 2), generator=gen, device=dev) * 0.08 - 0.04
        nrminv = 0.02 * (torch.rand(n, generator=gen, device=dev) + 0.5)
        return [ps.pack_int4(q), dirs, nrminv, torch.zeros(n, device=dev)]
    V = torch.randn((n, S), generator=gen, device=dev)
    c = snnls.make_consts(V.T, V.sum(dim=0), select_dtype=getattr(torch, kind))
    dirs = torch.randn((S, 2), generator=gen, device=dev)
    dirs /= torch.linalg.vector_norm(dirs, dim=0)
    return [c.Vsel, dirs[:dirs_S].contiguous(), c.norms, c.valid]


def _hold_wide(kind, args, expect_idx=None):
    kernel, plain = KERNELS["packed" if kind == "packed" else "giga"]
    counter = ps if kind == "packed" else gs
    before = counter.launches
    ki, ks = kernel(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    pi, pscore = plain(*args)
    assert int(ki) == int(pi)
    if expect_idx is not None:
        assert int(ki) == expect_idx
    if float(pscore) == -np.inf:
        assert float(ks) == -np.inf
    else:
        np.testing.assert_allclose(float(ks), float(pscore), rtol=WIDE_RTOL[kind])
    return int(pi)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S,n,dirs_S", WIDE, ids=WIDE_IDS)
def test_wide_rows_match_plain(kind, S, n, dirs_S, cuda_device):
    """Random directions, then the winner invalid, then copies of the winner
    before and after it (the first wins), then every row invalid."""
    args = _wide_inputs(kind, S, cuda_device, n=n, dirs_S=dirs_S)
    row_bytes = args[0].shape[1] * args[0].element_size()
    assert row_bytes > (32 if kind == "packed" else 48) * 1024
    f = _hold_wide(kind, args)
    dead = list(args)
    if kind == "packed":
        dead[3] = args[3].clone()
        dead[3][f] = -np.inf
    else:
        dead[3] = args[3].clone()
        dead[3][f] = False
    if n > 1:
        assert _hold_wide(kind, dead) != f
    tied = list(args)
    tied[0], tied[2] = args[0].clone(), args[2].clone()
    first = f // 2 if f > 1 else f          # a copy before the winner, if there is room
    for j in (first, n - 1):
        tied[0][j], tied[2][j] = args[0][f], args[2][f]
    _hold_wide(kind, tied, expect_idx=min(first, f))
    dead[3] = (torch.full_like(args[3], -np.inf) if kind == "packed"
               else torch.zeros_like(args[3]))
    _hold_wide(kind, dead, expect_idx=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S,n", [("float32", 12289, 2051), ("float32", 16384, 2051),
                                      ("bfloat16", 24584, 2051), ("float32", 32772, 67)])
def test_wide_rows_repeat_bit_identical(kind, S, n, cuda_device):
    """100 launches of an f32 or bf16 wide-row select give the same (index,
    score) to the bit: the row sums are combined in a fixed order."""
    args = _wide_inputs(kind, S, cuda_device, n=n)
    out = [gs.giga_select(*args) for _ in range(100)]
    torch.cuda.synchronize()
    idx = torch.stack([o[0] for o in out]).cpu()
    bits = torch.stack([o[1] for o in out]).view(torch.int32).cpu()
    assert bool((idx == idx[0]).all()) and bool((bits == bits[0]).all())


@pytest.mark.cuda
def test_int8_dots_past_2_to_24(cuda_device):
    """int8 rows of 49168 columns aligned with +-1 directions: |dot| reaches
    7.9e8, where int32 -> f32 rounds (to nearest even, as the plain version's
    f64 -> f32 does)."""
    n, S = 300, 49168
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    sign = torch.randint(0, 2, (S,), generator=gen, device=cuda_device) * 2 - 1
    V = torch.randint(-127, 128, (n, S), generator=gen, device=cuda_device, dtype=torch.int8)
    for r, keep in ((17, S), (101, S - 1), (250, S - 3)):     # nearly equal, odd dots
        V[r, :keep] = (127 * sign[:keep]).to(torch.int8)
    dirs = torch.stack([sign.float(), torch.zeros(S, device=cuda_device)], dim=1).contiguous()
    args = [V, dirs, torch.ones(n, device=cuda_device),
            torch.ones(n, dtype=torch.bool, device=cuda_device)]
    ki, ks = gs.giga_select(*args)
    pi, pscore = gs.giga_select_ref(*args)
    assert int(ki) == int(pi) == 17
    assert float(ks) == float(pscore) and float(ks) * 127.0 * 127.0 > 2.0 ** 24


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "packed"])
def test_narrow_and_wide_calls_share_the_workspace(kind, cuda_device):
    """100 calls back to back on one stream, ring kernel and wide-row kernel
    in turn: both leave key and ticket zero for the other."""
    if kind == "packed":
        narrow = [t.to(cuda_device) for t in _packed_inputs(20000)]
        wide = _wide_inputs("packed", 65568, cuda_device, n=515)
    else:
        narrow = [t.to(cuda_device) for t in _giga_inputs(torch.int8, 20000)]
        wide = _wide_inputs("int8", 49168, cuda_device, n=515)
    kernel, plain = KERNELS["packed" if kind == "packed" else "giga"]
    want = [int(plain(*narrow)[0]), int(plain(*wide)[0])]
    got = [kernel(*(wide if r % 2 else narrow))[0] for r in range(100)]
    torch.cuda.synchronize()
    assert [int(g) for g in got] == want * 50


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["giga", "packed"])
def test_calls_on_two_streams(kind, cuda_device):
    make = (lambda seed: _giga_inputs(torch.int8, 30000, seed=seed)) if kind == "giga" \
        else (lambda seed: _packed_inputs(30000, seed=seed))
    kernel, plain = KERNELS[kind]
    inputs = [[t.to(cuda_device) for t in make(seed)] for seed in (6, 7)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(10):
        for args, st in zip(inputs, streams):
            with torch.cuda.stream(st):
                outs.append(kernel(*args))
    torch.cuda.synchronize()
    want = [int(plain(*args)[0]) for args in inputs]
    assert [int(o[0]) for o in outs] == want * 10
    keys = {k for k in gs._workspaces if k[1] in {s.cuda_stream for s in streams}}
    assert len(keys) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["giga", "packed"])
def test_each_select_is_one_launch(kind, cuda_device):
    from torch.profiler import ProfilerActivity, profile

    args = [t.to(cuda_device) for t in (_giga_inputs(torch.int8, 20000) if kind == "giga"
                                        else _packed_inputs(20000))]
    kernel, _ = KERNELS[kind]
    kernel(*args)                       # the stream's workspace exists from here on
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kernel(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3, [e.name for e in kernels]
    assert all(("select" in e.name) for e in kernels), [e.name for e in kernels]


@pytest.mark.cuda
def test_numpy_data_lands_on_the_card(cuda_device):
    rng = np.random.default_rng(8)
    z = rng.normal(size=(3000, 4)).astype(np.float32)
    proj = bc.BlackBoxProjector(
        lambda g, n, w, p: 0.1 * torch.randn((n, 4), generator=g, device=g.device), 64,
        lambda p, th: -torch.nn.functional.softplus(-(p @ th.T)))
    c = bc.HilbertCoreset(z, proj, select_dtype=torch.int8)
    assert c.data.device == torch.device("cuda", 0) == proj.device
    assert c.snnls.consts.Vsel.device == torch.device("cuda", 0)
    c.build(10)
    assert c.size() > 0


def _gauss_logp(device):
    prec = torch.linalg.inv(torch.tensor([[2.0, 1.2], [1.2, 1.5]], device=device))
    return lambda th: -0.5 * torch.sum((th @ prec) * th, dim=-1)


class _CpuDraws(mcmc.Draws):
    """A draw source that draws on the CPU and moves the draws to the chains'
    device (a test's replay source: a ``Draws`` itself refuses a generator
    on another device than the chains)."""

    def _on(self, device):
        return self.gen.device

    def momentum(self, shape, dtype, device):
        return super().momentum(shape, dtype, "cpu").to(device)

    def direction(self, n, device):
        return super().direction(n, "cpu").to(device)

    def leaf_uniforms(self, L, n, device):
        return super().leaf_uniforms(L, n, "cpu").to(device)

    def tree_uniform(self, n, device):
        return super().tree_uniform(n, "cpu").to(device)


@pytest.mark.cuda
def test_nuts_transition_on_card_matches_cpu(cuda_device):
    """The same draws (made on the CPU, moved to each device by a draw
    source) give the same batched transition on the card as on the CPU."""
    z = torch.as_tensor(np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32))
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        vg = integrators.value_and_grad(_gauss_logp(dev))
        zd = z.to(dev)
        st = integrators.IntegratorState(zd, torch.zeros_like(zd), *vg(zd))
        st, info = nuts.nuts_kernel(vg, _CpuDraws(torch.Generator().manual_seed(1)), st,
                                    0.4, torch.ones(64, 2, device=dev), max_depth=8)
        out.append((st.z.cpu(), info.num_steps.cpu()))
    np.testing.assert_array_equal(out[0][1].numpy(), out[1][1].numpy())
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_nuts_gaussian_moments_on_card(cuda_device):
    res = mcmc.run_nuts(_gauss_logp(cuda_device), torch.zeros((256, 2), device=cuda_device),
                        torch.Generator(device=cuda_device).manual_seed(0),
                        num_warmup=150, num_samples=150)
    s = res.samples.reshape(-1, 2).cpu().numpy()
    np.testing.assert_allclose(s.mean(0), np.zeros(2), atol=0.05)
    np.testing.assert_allclose(np.cov(s, rowvar=False), [[2.0, 1.2], [1.2, 1.5]], rtol=0.05)
    assert float(mcmc.split_rhat(res.samples).max()) < 1.05
    assert int(res.num_divergent.sum()) == 0


@pytest.mark.cuda
def test_nn_opt_on_card_matches_cpu(cuda_device):
    t = torch.as_tensor(np.random.default_rng(3).normal(size=64).astype(np.float32))
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        td = t.to(dev)
        mask = torch.arange(64, device=dev) < 40
        x = nn_opt(torch.zeros(64, device=dev), lambda x, g: x - td, torch.Generator(device=dev),
                   nn_mask=mask, opt_itrs=200)
        assert x.device.type == dev.type
        out.append(x.cpu().numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-7)


def _svi_problem(dev, n=300, d=12):
    x = torch.as_tensor((1.0 + np.random.default_rng(0).normal(size=(n, d))).astype(np.float32))
    eye = torch.eye(d)
    basis = gaussian.posterior_basis(torch.zeros(d), eye, eye)    # one basis for both
    fam = bc.gaussian_tangent_family(torch.zeros(d, device=dev), eye.to(dev), eye.to(dev),
                                     eye.to(dev), basis=type(basis)(*(b.to(dev) for b in basis)))
    return x.to(dev), fam


@pytest.mark.cuda
def test_svi_exact_on_card_matches_cpu(cuda_device):
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        x, fam = _svi_problem(dev)
        c = bc.SparseVICoreset(x, fam, opt_itrs=20, capacity=32)
        c.build(32)
        assert c._wts.device.type == dev.type
        out.append(c.get())
    assert out[0][2].size >= 20
    np.testing.assert_array_equal(out[1][2], out[0][2])
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-4, atol=1e-6)


def _bb_family(dev, d, S=40):
    eye = torch.eye(d, device=dev)
    basis = gaussian.posterior_basis(torch.zeros(d, device=dev), eye, eye)

    def sampler(g, n, w, p):
        if p.numel() == 0:
            w, p = torch.zeros(1, device=dev), torch.zeros((1, d), device=dev)
        return gaussian.sample_weighted_post_basis(g, basis, p, w, n)

    return bc.coresets.blackbox_family(
        sampler, S, lambda p, th: gaussian.log_likelihood(p, th, eye, 0.0),
        lambda p, th: gaussian.grad_x_log_likelihood(p, th, eye))


def _syncs(fn):
    """(fn(), the source lines of the synchronizing CUDA calls fn made)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
def test_bpsvi_joint_step_on_card(cuda_device):
    x = torch.as_tensor((1.0 + np.random.default_rng(1).normal(size=(2000, 5))).astype(np.float32))
    x = x.to(cuda_device)
    fam = _bb_family(cuda_device, 5)
    init = bpsvi.uniform_init_idcs(2000, 10, torch.Generator(device=cuda_device))
    (w, p), syncs = _syncs(lambda: bpsvi.bpsvi_build(
        x, init, torch.Generator(device=cuda_device), family=fam, n_sub_opt=256,
        opt_itrs=1, step_sched=lambda i: 1.0 / (1.0 + i)))
    assert w.is_cuda and p.is_cuda and p.shape == (10, 5)
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(p).all())
    assert syncs == []


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["basis", "logistic"])
def test_svi_and_bpsvi_builds_stay_on_the_card(kind, cuda_device):
    """No Adam step reads back: an SVI build reads one flag per select and
    nothing else, a BPSVI build nothing at all, directly (``graphs=False``)
    and replayed (after a first build has captured the graphs: a capture
    synchronizes), for the Gaussian basis sampler and the logistic
    driver's warm Laplace refit (its Cholesky factors read nothing)."""
    if kind == "basis":
        x = torch.as_tensor((1.0 + np.random.default_rng(2).normal(size=(500, 5)))
                            .astype(np.float32)).to(cuda_device)
        fam = _bb_family(cuda_device, 5)
    else:
        x, fam = _logistic_problem(cuda_device, n=500)
    w0 = torch.zeros(16, device=cuda_device)
    i0 = torch.full((16,), -1, dtype=torch.int64, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    for graphs in (False, None, None):
        (w, i, size), syncs = _syncs(lambda: sparsevi.svi_build(
            x, w0, i0, 0, gen, 6, family=fam, n_sub_sel=128, n_sub_opt=128, opt_itrs=15,
            step_sched=lambda i: 1.0 / (1.0 + i), graphs=graphs))
    assert w.is_cuda and i.is_cuda and 0 < size <= 6
    assert len(syncs) == 6 and all("coresets/sparsevi.py" in s for s in syncs), syncs
    init = bpsvi.uniform_init_idcs(500, 8, torch.Generator(device=cuda_device))
    for graphs in (False, None, None, None):
        (w, p), syncs = _syncs(lambda: bpsvi.bpsvi_build(
            x, init, gen, family=fam, n_sub_opt=128, opt_itrs=25,
            step_sched=lambda i: 1.0 / (1.0 + i), graphs=graphs))
        if graphs is False:
            assert syncs == []
    assert w.is_cuda and p.is_cuda and syncs == []


@pytest.mark.cuda
def test_optimize_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    A = rng.normal(size=(60, 150)).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        g = snnls.GIGA(torch.as_tensor(A, device=dev), torch.as_tensor(A.sum(axis=1), device=dev))
        g.build(40)
        e0 = g.error()
        g.optimize()
        assert not g.reached_numeric_limit and g.error() <= e0
        assert g.state.w.device.type == dev.type
        out.append((g.weights(), g.error()))
        g.optimize(solver="exact")
        assert g.error() <= out[-1][1] * (1 + 1e-3)
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5)


@pytest.mark.cuda
def test_select_past_2_to_32_bytes(cuda_device):
    """The int8 select over 2^23 + 5 rows of 512 bytes (4.3 GB): the winner
    in the last rows, an invalid stronger row before it, and a tie after it
    (the first wins).  The index must be exact against the plain version,
    which runs block by block."""
    n, S = (1 << 23) + 5, 512
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    V = torch.randint(-20, 21, (n, S), generator=gen, device=cuda_device, dtype=torch.int8)
    assert V.numel() > 2**32
    dirs = torch.randn((S, 2), generator=gen, device=cuda_device)
    dirs[:, 1] -= dirs[:, 0] * (dirs[:, 0] @ dirs[:, 1]) / (dirs[:, 0] @ dirs[:, 0])
    dirs /= torch.linalg.vector_norm(dirs, dim=0)
    top = torch.round(127.0 * dirs[:, 0] / dirs[:, 0].abs().max()).to(torch.int8)
    near = top.clone()
    near[0] = 0
    V[n - 4], V[n - 3], V[n - 2], V[n - 1] = top, near, near, near
    valid = torch.ones(n, dtype=torch.bool, device=cuda_device)
    valid[n - 4] = False
    norms = torch.ones(n, device=cuda_device)
    before = gs.launches
    ki, ks = gs.giga_select(V, dirs, norms, valid)
    assert gs.launches == before + 1
    pi, pscore = gs.giga_select_ref(V, dirs, norms, valid)
    assert int(ki) == int(pi) == n - 3
    np.testing.assert_allclose(float(ks), float(pscore), rtol=1e-6)
    valid[n - 4] = True                       # now the strongest row is live
    assert int(gs.giga_select(V, dirs, norms, valid)[0]) == n - 4


@pytest.mark.cuda
def test_streamed_build_on_card_matches_cpu(cuda_device):
    """HilbertCoreset(stream_chunk_size=) at N=20k on the card and on the
    CPU, from the same numpy data and θ samples, projected in f64 so that
    both quantize the same f32 vectors: equal int8 rows, the same atoms."""
    from bayesian_coresets_tpu_torch.coresets.projector import Projector, center_lls
    from bayesian_coresets_tpu_torch.models import logistic

    rng = np.random.default_rng(5)
    n, d, S = 20_000, 10, 500
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-x @ np.full(d, 3.0))), 1.0, -1.0)
    z = (y[:, None] * x).astype(np.float32)
    th = torch.as_tensor(0.1 * rng.normal(size=(S, d)))

    class F64Projector(Projector):
        def project(self, pts, grad=False):
            return center_lls(logistic.log_likelihood(pts.double(), th.to(pts.device))).float()

        def update(self, wts, pts):
            pass

    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        c = bc.HilbertCoreset(z, F64Projector(), stream_chunk_size=6000, max_active=1024,
                              device=dev)
        assert c.snnls.consts.V.device.type == dev.type and c.snnls.consts.V.dtype == torch.int8
        before = gs.launches
        c.build(200)
        if dev.type == "cuda":
            assert gs.launches - before == int(c.snnls.state.itr)
        out[dev.type] = (c.snnls.consts.V.cpu(), c.get())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    (wg, _, ig), (wc, _, ic) = out["cuda"][1], out["cpu"][1]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(wg, wc, rtol=1e-4)


@pytest.mark.cuda
def test_int8_resident_matvec_forms_no_f32_matrix(cuda_device):
    """_v_matvec on int8-resident constants gathers only the support's rows:
    its peak allocation stays far below the n x S x 4 bytes of an f32 V."""
    n, S, k = 1 << 20, 512, 1024
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    Vq = torch.randint(-127, 128, (n, S), generator=gen, device=cuda_device, dtype=torch.int8)
    norms = torch.rand(n, generator=gen, device=cuda_device) + 0.5
    c = snnls.make_consts_quantized(Vq, norms, torch.ones(S, device=cuda_device))
    w = torch.zeros(n, device=cuda_device)
    idx = torch.randperm(n, generator=gen, device=cuda_device)[:k]
    w[idx] = torch.rand(k, generator=gen, device=cuda_device) + 0.1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xw = snnls._v_matvec(c, w, support=k)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < n * S // 8
    rows = Vq[idx].double() * (norms[idx].double() / 127.0)[:, None]
    np.testing.assert_allclose(xw.cpu().numpy(), (w[idx].double() @ rows).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["GIGA", "FW"])
def test_synthetic_vectors_driver_on_card_matches_cpu(alg, cuda_device, tmp_path, monkeypatch):
    """The synthetic_vectors driver at a small size on the card and with
    --device cpu: the same sizes and errors (rtol 1e-4), and one select
    launch per solver iteration on the card."""
    from bayesian_coresets_tpu_torch.experiments import results
    from bayesian_coresets_tpu_torch.experiments import synthetic_vectors as sv

    monkeypatch.chdir(tmp_path)
    argv = ["run", "--alg", alg, "--data_num", "3000", "--data_dim", "64",
            "--coreset_size_max", "60", "--coreset_num_sizes", "8", "--trial", "4"]
    out = {}
    for dev in ("cuda", "cpu"):
        before = gs.launches
        coreset = sv.main(argv + ["--device", dev, "--results_folder", f"r_{dev}/"])
        launches = gs.launches - before
        assert coreset.snnls.consts.V.device.type == dev
        if dev == "cuda":
            assert launches == int(coreset.snnls.state.itr) > 0
        else:
            assert launches == 0
        out[dev] = results.load_matching({}, folder=f"r_{dev}/")
    np.testing.assert_array_equal(out["cuda"]["csize"], out["cpu"]["csize"])
    np.testing.assert_allclose(out["cuda"]["err"], out["cpu"]["err"], rtol=1e-4)


@pytest.mark.cuda
def test_logistic_cpu_fallback_moves_the_chains_off_the_card(cuda_device, tmp_path,
                                                            monkeypatch):
    """logistic_poisson with --cpu_fallback on the card: the full-data chains,
    the coreset's and its dense retry run on the card, the last retry on
    the CPU; without the flag nothing runs on the CPU."""
    from bayesian_coresets_tpu_torch.experiments import datasets
    from bayesian_coresets_tpu_torch.experiments import logistic_poisson as lp

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    n, d = 120, 3
    X = np.hstack([rng.normal(size=(n, d - 1)), np.ones((n, 1))])
    Y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-X @ np.ones(d))), 1.0, -1.0)
    data = (X.astype(np.float32), Y, (Y[:, None] * X).astype(np.float32), None, d)
    monkeypatch.setattr(datasets, "load_logistic", lambda name: data)
    devices = []
    run = lp.mcmc.run
    monkeypatch.setattr(lp.mcmc, "run", lambda model, pts, *a, **kw:
                        devices.append(pts.device.type) or run(model, pts, *a, **kw))
    argv = ["run", "--model", "lr", "--alg", "GIGA-OPT", "--mcmc_samples_full", "32",
            "--mcmc_samples_coreset", "32", "--mcmc_chains", "2", "--proj_dim", "32",
            "--coreset_size_max", "16", "--coreset_num_sizes", "1", "--fs_samples", "16",
            "--max_treedepth", "8", "--ess_gate", "10000"]
    info = lp.main(argv + ["--results_folder", "plain/"])
    assert devices == ["cuda", "cuda", "cuda"] and info["cpu_retries"] == 0
    devices.clear()
    info = lp.main(argv + ["--results_folder", "fallback/", "--cpu_fallback"])
    assert devices == ["cuda", "cuda", "cpu"] and info["cpu_retries"] == 1


@pytest.mark.cuda
def test_one_rank_nccl_build_sharded_equals_one_process(cuda_device, tmp_path):
    """A 1-rank NCCL group (the multi-GPU backend, every exchange a real
    all_reduce) runs build_sharded at N=20k, S=500 (int8 select, 200
    iterations): the same weights, bit for bit, as the build in one
    process, with one select launch and two exchanges per iteration."""
    import torch.distributed as dist

    from bayesian_coresets_tpu_torch import parallel as P

    if not dist.is_nccl_available():
        pytest.fail("this PyTorch build has no NCCL")
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.normal(size=(500, 20_000)).astype(np.float32), device=cuda_device)
    b = A.sum(dim=1)
    c = snnls.make_consts(A, b, select_dtype=torch.int8)
    one = snnls.build(c, snnls.init_state(c, 1024), 200, 1e-6)
    P.initialize(f"file://{tmp_path / 'init'}", 1, 0, "nccl")
    try:
        mesh = P.make_mesh()
        gs.launches = 0
        fused = gst.launches
        st = P.build_sharded(A, b, 200, mesh, select_dtype=torch.int8, max_active=1024)
        assert gs.launches == int(st.itr) == 200 and gst.launches == fused
        assert mesh.ledger.calls["argmax"] == mesh.ledger.calls["row"] == 200
    finally:
        dist.destroy_process_group()
    assert torch.equal(st.w, one.w) and int((st.w > 0).sum()) > 100


# the proj axis's select: the dots-only mode (ring and wide-row kernels) and
# the score of summed dots
DOTS_SHAPES = [("int8", 500, 5003), ("bfloat16", 500, 5003), ("float32", 500, 5003),
               ("int8", 49168, 515), ("bfloat16", 24584, 515), ("float32", 12289, 515),
               ("float32", 16384, 2051)]


def _dots_close(kd, pd, kind):
    """int32 dots equal; f32 within 1e-5 of the row's sum of absolute
    products' scale (sums in another order)."""
    if kind == "int8":
        assert kd.dtype == torch.int32
        torch.testing.assert_close(kd, pd, rtol=0, atol=0)
    else:
        assert kd.dtype == torch.float32
        scale = pd.abs().max().item()
        torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S,n", DOTS_SHAPES, ids=[f"{k}-{S}" for k, S, _ in DOTS_SHAPES])
def test_dots_kernel_matches_plain(kind, S, n, cuda_device):
    """``giga_dots`` against ``giga_dots_ref``, on rows the ring kernel takes
    and rows past 48 KB (the wide-row kernel): one launch each."""
    Vsel, dirs, _, _ = _wide_inputs(kind, S, cuda_device, n=n)
    before = gs.dots_launches
    kd = gs.giga_dots(Vsel, dirs)
    torch.cuda.synchronize()
    assert gs.dots_launches == before + 1 and kd.shape == (n, 2)
    _dots_close(kd, gs.giga_dots_ref(Vsel, dirs), kind)


@pytest.mark.cuda
def test_dots_kernel_past_2_to_24_rows(cuda_device):
    """int8 dots of 2^24 + 5 rows: the row index of the output is 64-bit."""
    n, S = (1 << 24) + 5, 32
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    V = torch.randint(-127, 128, (n, S), generator=gen, device=cuda_device, dtype=torch.int8)
    dirs = torch.nn.functional.normalize(torch.randn((S, 2), generator=gen, device=cuda_device),
                                         dim=0)
    kd = gs.giga_dots(V, dirs)
    torch.cuda.synchronize()
    torch.testing.assert_close(kd, gs.giga_dots_ref(V, dirs), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_score_kernel_matches_plain(dtype, case, cuda_device):
    """``giga_score_select`` on the dots of ``giga_dots_ref`` against its
    plain version: the index identical (ties to the first row, all invalid
    to row 0), the score within 1e-6 relative; and on the unsplit dots it
    gives the fused kernel's (index, score) bit for bit."""
    Vsel, dirs, norms, valid = [t.to(cuda_device) for t in _select_inputs(case, dtype)]
    dots = gs.giga_dots_ref(Vsel, dirs)
    before = gs.score_launches
    ki, ks = gs.giga_score_select(dots, norms, valid)
    torch.cuda.synchronize()
    assert gs.score_launches == before + 1
    pi, pscore = gs.giga_score_select_ref(dots, norms, valid)
    assert int(ki) == int(pi)
    if case == "all_invalid":
        assert int(ki) == 0 and float(ks) == -np.inf
    else:
        np.testing.assert_allclose(float(ks), float(pscore), rtol=1e-6)
    if case == "ties":
        assert int(ki) == 7
    fi, fs = gs.giga_select(Vsel, dirs, norms, valid)
    si, ss = gs.giga_score_select(gs.giga_dots(Vsel, dirs), norms, valid)
    assert int(si) == int(fi) and float(ss) == float(fs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_dots_summed_equal_the_fused_select(dtype, cuda_device):
    """Column blocks of whole 16-byte rows, each with its slice of the
    directions, through the dots kernel and summed: int8 sums equal the
    unsplit dots and the score kernel then gives the fused select's result
    to the bit; f32 and bf16 sums agree within 1e-5 and pick its index."""
    Vsel, dirs, norms, valid = [t.to(cuda_device) for t in _select_inputs("random", dtype)]
    mult = gs.col_multiple(Vsel.dtype)
    cut = [0, 10 * mult, 21 * mult, Vsel.shape[1]]
    parts = [gs.giga_dots(Vsel[:, a:b].contiguous(), dirs[a:min(b, dirs.shape[0])])
             for a, b in zip(cut, cut[1:])]
    summed = sum(parts)
    whole = gs.giga_dots(Vsel, dirs)
    _dots_close(summed, whole, str(dtype).replace("torch.", ""))
    fi, fs = gs.giga_select(Vsel, dirs, norms, valid)
    si, ss = gs.giga_score_select(summed, norms, valid)
    assert int(si) == int(fi)
    if dtype == torch.int8:
        assert float(ss) == float(fs)
    else:
        np.testing.assert_allclose(float(ss), float(fs), rtol=1e-5)


@pytest.mark.cuda
def test_score_calls_on_two_streams(cuda_device):
    """Score launches on two streams each use their stream's workspace."""
    inputs = []
    for seed in (6, 7):
        Vsel, dirs, norms, valid = [t.to(cuda_device) for t in _giga_inputs(torch.int8, 30000,
                                                                            seed=seed)]
        inputs.append((gs.giga_dots_ref(Vsel, dirs), norms, valid))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(10):
        for args, st in zip(inputs, streams):
            with torch.cuda.stream(st):
                outs.append(gs.giga_score_select(*args))
    torch.cuda.synchronize()
    want = [int(gs.giga_score_select_ref(*args)[0]) for args in inputs]
    assert [int(o[0]) for o in outs] == want * 10
    keys = {k for k in gs._workspaces if k[1] in {s.cuda_stream for s in streams}}
    assert len(keys) == 2


# Mid-width rows, 4-48 KB: past the ring kernel's 4 KB (int8: 4608 bytes)
# they take the wide-row kernel, in groups of 8 rows walked in 4 KB pieces.
# (kind, S): 4096 bytes (the ring kernel's last f32 and bf16 width), 4112
# (the first past it: a second piece of one chunk), 4608 and 4624 (the
# int8 limit and the first int8 width past it), 5120 and 5136, 6 KB, 8 KB
# and 8208 (a third piece of one chunk), 16 and 32 KB, linear_regression's
# f32 rows (10301 columns, padded to 41216 bytes) and 48 KB; n=1037 is off
# every group of 8 rows and every block's share.
MID_ROW_BYTES = [4096, 4112, 4608, 4624, 5120, 5136, 6144, 8192, 8208, 16384, 32768, 41216,
                 49152]
MID_ELEM = {"int8": 1, "bfloat16": 2, "float32": 4}
MID = [(k, 10301 if (k, rb) == ("float32", 41216) else rb // e)
       for rb in MID_ROW_BYTES for k, e in MID_ELEM.items()]
MID_IDS = [f"{k}-{S}" for k, S in MID]
MID_N = 1037


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S", MID, ids=MID_IDS)
def test_mid_rows_match_plain(kind, S, cuda_device):
    """Random directions, the winner invalid, copies of the winner far
    before it and at the last row (the first wins), every row invalid."""
    args = _wide_inputs(kind, S, cuda_device, n=MID_N, seed=S)
    row_bytes = args[0].shape[1] * args[0].element_size()
    assert 4096 <= row_bytes <= 48 * 1024
    f = _hold_wide(kind, args)
    dead = list(args)
    dead[3] = args[3].clone()
    dead[3][f] = False
    assert _hold_wide(kind, dead) != f
    tied = list(args)
    tied[0], tied[2] = args[0].clone(), args[2].clone()
    first = f // 2 if f > 1 else f
    for j in (first, MID_N - 1):
        tied[0][j], tied[2][j] = args[0][f], args[2][f]
    _hold_wide(kind, tied, expect_idx=min(first, f))
    dead[3] = torch.zeros_like(args[3])
    _hold_wide(kind, dead, expect_idx=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S", MID, ids=MID_IDS)
def test_mid_rows_dots_match_plain(kind, S, cuda_device):
    """The dots-only mode at mid-width rows: int8 dots equal the plain
    version's, f32 and bf16 within 1e-5 of the largest; one launch."""
    Vsel, dirs, _, _ = _wide_inputs(kind, S, cuda_device, n=MID_N, seed=S + 1)
    before = gs.dots_launches
    kd = gs.giga_dots(Vsel, dirs)
    torch.cuda.synchronize()
    assert gs.dots_launches == before + 1 and kd.shape == (MID_N, 2)
    _dots_close(kd, gs.giga_dots_ref(Vsel, dirs), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S", [("float32", 1028), ("bfloat16", 2056), ("float32", 4096),
                                    ("float32", 10301), ("bfloat16", 24576)])
def test_mid_rows_repeat_bit_identical(kind, S, cuda_device):
    """100 launches of an f32 or bf16 mid-width select, and 10 of its
    dots-only mode, give the same bits: the row sums are combined in a
    fixed order."""
    args = _wide_inputs(kind, S, cuda_device, n=MID_N, seed=S + 2)
    out = [gs.giga_select(*args) for _ in range(100)]
    dots = [gs.giga_dots(args[0], args[1]) for _ in range(10)]
    torch.cuda.synchronize()
    idx = torch.stack([o[0] for o in out]).cpu()
    bits = torch.stack([o[1] for o in out]).view(torch.int32).cpu()
    assert bool((idx == idx[0]).all()) and bool((bits == bits[0]).all())
    assert all(torch.equal(d.view(torch.int32), dots[0].view(torch.int32)) for d in dots)


def _score_inputs(kind, n, dev, seed=0):
    """(dots, norms, valid) of a score select on ``dev``: int32 dots of an
    int8 select (|d| <= 127^2), or f32 sums with their row norms; a tenth
    of the rows invalid."""
    rng = np.random.default_rng(seed)
    norms = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    if kind == "int8":
        dots = rng.integers(-16129, 16130, size=(n, 2)).astype(np.int32)
    else:
        dots = (rng.uniform(-1.0, 1.0, size=(n, 2)) * norms[:, None]).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return [torch.as_tensor(a, device=dev) for a in (dots, norms, valid)]


def _hold_score(args, expect_idx=None):
    ki, ks = gs.giga_score_select(*args)
    pi, pscore = gs.giga_score_select_ref(*args)
    assert int(ki) == int(pi)
    if expect_idx is not None:
        assert int(ki) == expect_idx
    if float(pscore) == -np.inf:
        assert float(ks) == -np.inf
    else:
        assert float(ks) == float(pscore)
    return int(pi)


# n=1, off a warp and a block's 288 rows, and past one pass of the grid
# (4 blocks of 288 rows an SM: 152064 rows on the H100)
SCORE_N = [1, 2, 15, 17, 4095, 4097, 32771, 100_000, 1_200_007]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCORE_N)
@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_score_kernel_row_counts(kind, n, cuda_device):
    """The score kernel at row counts off a warp, a block, the grid's step
    and its passes: the plain version's index and score (the same
    arithmetic: equal), then with every row invalid (row 0, -inf)."""
    args = _score_inputs(kind, n, cuda_device, seed=n)
    before = gs.score_launches
    _hold_score(args)
    assert gs.score_launches == before + 1
    _hold_score([args[0], args[1], torch.zeros_like(args[2])], expect_idx=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_score_kernel_ties_at_the_first_and_last_rows(kind, cuda_device):
    """The winner copied to row 0 (row 0 wins) and to the last row (the
    first copy wins); the only maximum at the last row, off every block's
    step; and the same on views one row in (off 16-byte alignment)."""
    n = 100_003
    dots, norms, valid = _score_inputs(kind, n, cuda_device, seed=5)
    valid[:] = True
    f = _hold_score([dots, norms, valid])
    for places, want in (((0, n - 1), 0), ((n - 1,), min(f, n - 1)), ((f // 3, n - 1), f // 3)):
        d, nr = dots.clone(), norms.clone()
        for j in places:
            d[j], nr[j] = dots[f], norms[f]
        _hold_score([d, nr, valid], expect_idx=want)
    d, nr = dots.clone(), norms.clone()
    d[f], nr[f] = d[0], nr[0]                 # the old winner no longer wins
    d[n - 1], nr[n - 1] = dots[f], norms[f]   # the only copy of it, at the last row
    _hold_score([d, nr, valid], expect_idx=n - 1)
    # views one row in: dots 8 bytes, norms 4 and valid 1 off 16-byte alignment
    _hold_score([d[1:], nr[1:], valid[1:]], expect_idx=n - 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_score_kernel_back_to_back_on_one_workspace(kind, cuda_device):
    """100 score launches on one stream with no reset between them, an
    all-invalid one among them: each leaves the key and ticket zero."""
    dots, norms, valid = _score_inputs(kind, 100_000, cuda_device, seed=9)
    variants = []
    for k in range(5):                        # the valid rows of a fifth each: 5 winners
        ok = valid.clone()
        ok[: 20_000 * k] = False
        ok[20_000 * (k + 1):] = False
        variants.append([dots, norms, ok])
    want = [int(gs.giga_score_select_ref(*v)[0]) for v in variants]
    assert [w // 20_000 for w in want] == list(range(5))
    args = variants[0]
    got, dead_out = [], None
    for r in range(100):
        if r == 50:
            dead_out = gs.giga_score_select(args[0], args[1], torch.zeros_like(args[2]))
        got.append(gs.giga_score_select(*variants[r % 5])[0])
    torch.cuda.synchronize()
    assert [int(g) for g in got] == [want[r % 5] for r in range(100)]
    assert int(dead_out[0]) == 0 and float(dead_out[1]) == -np.inf


# ---------------------------------------------------------------------------
# The build loop and the FISTA solve as replayed CUDA graphs (ops/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_KINDS = ["int8", "bfloat16", "float32", "int8_resident"]
GRAPH_METHODS = ["giga", "frankwolfe", "orthopursuit", "importance", "uniform"]


def _graph_consts(kind, method, dev, n=3000, S=256, seed=1):
    """Constants on the card: a select copy of ``kind``, or int8-resident."""
    from bayesian_coresets_tpu_torch.parallel import quantize_chunk
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    A *= rng.uniform(0.2, 3.0, size=n).astype(np.float32)
    At = torch.as_tensor(A, device=dev)
    sampling = method if method in ("importance", "uniform") else None
    if kind == "int8_resident":
        q, nrm, bsum = quantize_chunk(At.T.contiguous(), n)
        return snnls.make_consts_quantized(q, nrm, bsum.float(), sampling=sampling)
    return snnls.make_consts(At, At.sum(dim=1), sampling=sampling,
                             select_dtype=getattr(torch, kind))


def _same_state(a, b):
    for name in snnls.SNNLSState._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


def _gen(dev, method, seed=3):
    return torch.Generator(device=dev).manual_seed(seed) \
        if method in ("importance", "uniform") else None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRAPH_KINDS)
@pytest.mark.parametrize("method", GRAPH_METHODS)
def test_replayed_build_equals_one_iteration_segments(method, kind, cuda_device):
    """From iteration 50 (mid-segment) to a mid-segment end, replayed graphs
    against one-iteration segments on the card: the state bit for bit, the
    select launched once per iteration (replays counted), and a sampling
    build's generator left where the eager draws leave it."""
    from bayesian_coresets_tpu_torch.ops import graphs
    c = _graph_consts(kind, method, cuda_device)
    head, span = (20, 30) if method == "orthopursuit" else (50, 100)
    s0 = snnls.build(c, snnls.init_state(c, 256), head, 1e-6, method=method,
                     draws=_gen(cuda_device, method, 2), segment=1)
    g1, g2 = _gen(cuda_device, method), _gen(cuda_device, method)
    ref = snnls.build(c, s0, span, 1e-6, method=method, draws=g1, segment=1)
    before, ran, caps = gs.launches, snnls.itrs_run, graphs.captures
    out = snnls.build(c, s0, span, 1e-6, method=method, draws=g2)
    torch.cuda.synchronize()
    assert int(ref.itr) == head + span and not bool(ref.done)
    _same_state(out, ref)
    assert snnls.itrs_run - ran == span and graphs.captures > caps
    select = method in ("giga", "frankwolfe", "orthopursuit")
    assert gs.launches - before == (span if select else 0)
    if g1 is not None:
        assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["giga", "importance"])
def test_replayed_build_continues_a_replayed_one(method, cuda_device):
    """Two replayed builds (70 + 90) against the same two builds in
    one-iteration segments (a build ends by folding the carried scale into
    the weights, so it is not one build of 160); the second replays the
    first's graphs where it can."""
    from bayesian_coresets_tpu_torch.ops import graphs
    c = _graph_consts("int8", method, cuda_device)
    g = _gen(cuda_device, method)
    ref = snnls.build(c, snnls.init_state(c, 256), 70, 1e-6, method=method, draws=g,
                      segment=1)
    ref = snnls.build(c, ref, 90, 1e-6, method=method, draws=g, segment=1)
    g = _gen(cuda_device, method)
    s = snnls.build(c, snnls.init_state(c, 256), 70, 1e-6, method=method, draws=g)
    caps = graphs.captures
    s = snnls.build(c, s, 90, 1e-6, method=method, draws=g)
    _same_state(s, ref)
    # 0..70 = 64 + (4 + 2); 70..160 = (32 + 16 + 8 + 2) + 32 refreshing: four new
    # pieces, (32, 16, 8) and the refreshing 32
    assert graphs.captures - caps == 4


@pytest.mark.cuda
def test_replayed_builds_on_two_streams(cuda_device):
    """Builds on two streams, each with graphs and a workspace of its own,
    interleaved: each equals the one-iteration build."""
    c = _graph_consts("int8", "giga", cuda_device)
    ref = snnls.build(c, snnls.init_state(c, 256), 150, 1e-6, segment=1)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for _ in range(2):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(snnls.build(c, snnls.init_state(c, 256), 150, 1e-6))
    torch.cuda.synchronize()
    for out in outs:
        _same_state(out, ref)


@pytest.mark.cuda
def test_repeated_replayed_builds_hold_their_memory(cuda_device):
    """Once captured, repeated builds replay the same graphs and allocate
    nothing that stays."""
    from bayesian_coresets_tpu_torch.ops import graphs
    c = _graph_consts("int8", "giga", cuda_device)
    snnls.build(c, snnls.init_state(c, 256), 150, 1e-6)
    torch.cuda.synchronize()
    mem, caps = torch.cuda.memory_allocated(), graphs.captures
    for _ in range(5):
        out = snnls.build(c, snnls.init_state(c, 256), 150, 1e-6)
        del out
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == mem and graphs.captures == caps


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["giga", "frankwolfe", "orthopursuit", "uniform"])
def test_replayed_latch_inside_a_segment(method, cuda_device):
    """A support overflow latches ``done`` inside the first segment (OMP,
    whose segments hold 4 iterations: max_active=2, so the third atom
    latches; else 3): the state is the one-iteration run's, and the select
    launched once per iteration the segment ran, the gated ones included."""
    c = _graph_consts("int8", method, cuda_device)
    length, K = (4, 2) if method == "orthopursuit" else (64, 3)
    ref = snnls.build(c, snnls.init_state(c, K), 100, 1e-6, method=method,
                      draws=_gen(cuda_device, method), segment=1)
    before, ran = gs.launches, snnls.itrs_run
    out = snnls.build(c, snnls.init_state(c, K), 100, 1e-6, method=method,
                      draws=_gen(cuda_device, method))
    torch.cuda.synchronize()
    _same_state(out, ref)
    assert bool(out.done) and int(out.itr) < length and snnls.itrs_run - ran == length
    assert gs.launches - before == (0 if method == "uniform" else length)


@pytest.mark.cuda
def test_replayed_build_reads_once_per_segment(cuda_device):
    """A replayed GIGA build of 150 from 0 (segments 64 + 64 + 22) reads the
    state's (itr, done) on entry and one pair per segment, nothing more."""
    c = _graph_consts("int8", "giga", cuda_device)
    snnls.build(c, snnls.init_state(c, 256), 150, 1e-6)         # captures
    state = snnls.init_state(c, 256)
    torch.cuda.synchronize()
    _, syncs = _syncs(lambda: snnls.build(c, state, 150, 1e-6))
    assert len(syncs) == 1 + 3, syncs


@pytest.mark.cuda
def test_replayed_build_refuses_a_draw_source(cuda_device):
    class Source:
        def index(self, cdf):
            return torch.zeros(1, dtype=torch.int64, device=cdf.device)

    c = _graph_consts("float32", "importance", cuda_device)
    with pytest.raises(ValueError, match="segment=1"):
        snnls.build(c, snnls.init_state(c, 16), 10, 1e-6, method="importance", draws=Source())
    s = snnls.build(c, snnls.init_state(c, 16), 10, 1e-6, method="importance",
                    draws=Source(), segment=1)
    assert float(s.cts[0]) == 10


@pytest.mark.cuda
def test_capture_raises_on_a_host_read(cuda_device):
    """No fallback: a host read inside a capture raises."""
    from bayesian_coresets_tpu_torch.ops import graphs
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError):
        graphs.Graph(lambda: x.sum().item(), graphs.side_stream(x.device),
                     torch.cuda.graph_pool_handle())


@pytest.mark.cuda
def test_optimize_replayed_equals_the_uncaptured_solve(cuda_device):
    """optimize_active through its graph against the same solve run
    uncaptured on the card, bit for bit; a second active set of the same
    padded size replays the graph."""
    from bayesian_coresets_tpu_torch.ops import graphs
    c = _graph_consts("int8", "giga", cuda_device)
    s = snnls.build(c, snnls.init_state(c, 256), 40, 1e-6)
    for size in (int(s.size), int(s.size) - 5):
        idcs = torch.zeros(64, dtype=torch.int32, device=cuda_device)
        idcs[:size] = s.idcs[:size]
        caps = graphs.captures
        out, ok = snnls.optimize_active(c, s, idcs, size, 1e-6)
        w, xw, done, ok2 = snnls._optimize_core(c, s.w, s.xw, s.done, idcs, size, 1e-6, 512)
        torch.cuda.synchronize()
        assert torch.equal(out.w.view(torch.int32), w.view(torch.int32))
        assert torch.equal(out.xw.view(torch.int32), xw.view(torch.int32))
        assert bool(out.done) == bool(done) and bool(ok) == bool(ok2)
        assert graphs.captures - caps == (1 if size == int(s.size) else 0)


@pytest.mark.cuda
def test_optimize_facade_replays_fista(cuda_device):
    """SparseNNLS.optimize("fista") on the card: one graph per padded size,
    the cost not raised."""
    from bayesian_coresets_tpu_torch.ops import graphs
    rng = np.random.default_rng(4)
    A = rng.normal(size=(128, 2000)).astype(np.float32)
    g = snnls.GIGA(torch.as_tensor(A, device=cuda_device),
                   torch.as_tensor(A.sum(axis=1), device=cuda_device), max_active=128)
    g.build(30)
    e0 = g.error()
    caps, reps = graphs.captures, graphs.replays
    g.optimize()
    assert graphs.captures - caps == 1 and graphs.replays - reps == 1
    assert g.error() <= e0 * (1 + 1e-6) and not g.reached_numeric_limit


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1000, (1 << 20) + 3])
def test_fold_kernel_matches_plain(n, flag, cuda_device):
    """The gated fold kernel against its plain version, on a 16-byte aligned
    vector and on one 4 bytes off (the kernel's scalar path): bit for bit,
    one launch each."""
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs
    rng = np.random.default_rng(n)
    w0 = torch.as_tensor(rng.uniform(0.0, 3.0, size=n + 1).astype(np.float32),
                         device=cuda_device)
    f = torch.tensor(flag, device=cuda_device)
    s = torch.tensor(np.float32(3e-11), device=cuda_device)
    for wk in (w0[:n].clone(), w0.clone()[1:]):
        wp = wk.clone()
        before = fs.launches
        fs.fold_scale(wk, f, s)
        fs.fold_scale_ref(wp, f, s)
        torch.cuda.synchronize()
        assert fs.launches == before + 1
        assert torch.equal(wk.view(torch.int32), wp.view(torch.int32))


@pytest.mark.cuda
def test_replayed_build_launches_the_fold_once_per_iteration(cuda_device):
    """GIGA and Frank-Wolfe launch the fold kernel once per iteration run,
    replays counted; OMP and the sampling solvers never."""
    from bayesian_coresets_tpu_torch.ops import fold_scale as fs
    for method, per in (("giga", 1), ("frankwolfe", 1), ("orthopursuit", 0), ("uniform", 0)):
        c = _graph_consts("int8", method, cuda_device)
        before, ran = fs.launches, snnls.itrs_run
        snnls.build(c, snnls.init_state(c, 256), 70, 1e-6, method=method,
                    draws=_gen(cuda_device, method))
        assert fs.launches - before == per * (snnls.itrs_run - ran) == per * 70


# ------------------- one graph set per shape (ops/graphs.py: set_key, Statics)


def _gen_at(gen, seed=3):
    return None if gen is None else gen.manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("method,kind", [
    ("giga", "int8"), ("giga", "float32"), ("giga", "bfloat16"), ("frankwolfe", "int8"),
    ("orthopursuit", "int8"), ("importance", "float32"), ("uniform", "int8")])
def test_shared_build_on_new_constants_captures_nothing(method, kind, cuda_device):
    """Two constants of one shape from other data: the second replayed build
    captures no graph, each build equals its own one-iteration build bit
    for bit, and the first constants' tensors are left as they were (a
    sampling build draws from one generator, reseeded)."""
    from bayesian_coresets_tpu_torch.ops import graphs
    gc.collect()
    itrs = 30 if method == "orthopursuit" else 150
    a, b = (_graph_consts(kind, method, cuda_device, seed=seed) for seed in (1, 2))
    a0 = [t.clone() for t in a]
    gen, outs, caps = _gen(cuda_device, method), [], []
    for c in (a, b):
        before = graphs.captures
        outs.append(snnls.build(c, snnls.init_state(c, 256), itrs, 1e-6, method=method,
                                draws=_gen_at(gen)))
        caps.append(graphs.captures - before)
    assert caps[0] > 0 and caps[1] == 0
    for c, out in zip((a, b), outs):
        ref = snnls.build(c, snnls.init_state(c, 256), itrs, 1e-6, method=method,
                          draws=_gen(cuda_device, method), segment=1)
        _same_state(out, ref)
    assert all(torch.equal(x, y) for x, y in zip(a, a0))


@pytest.mark.cuda
def test_interleaved_constants_read_their_own(cuda_device):
    """Builds on constants A, B, A of one shape: each equals its own
    one-iteration build bit for bit; only the first captures."""
    from bayesian_coresets_tpu_torch.ops import graphs
    gc.collect()
    a, b = (_graph_consts("int8", "giga", cuda_device, seed=seed) for seed in (1, 2))
    refs = [snnls.build(c, snnls.init_state(c, 256), 150, 1e-6, segment=1) for c in (a, b)]
    caps = []
    for c, ref in ((a, refs[0]), (b, refs[1]), (a, refs[0])):
        before = graphs.captures
        _same_state(snnls.build(c, snnls.init_state(c, 256), 150, 1e-6), ref)
        caps.append(graphs.captures - before)
    assert caps[0] > 0 and caps[1:] == [0, 0]
    assert not torch.equal(refs[0].w, refs[1].w)


@pytest.mark.cuda
def test_optimize_on_a_second_coreset_captures_nothing(cuda_device):
    """optimize_active on a coreset of constants of the first's shape, at
    the same padded size: no capture, and the uncaptured solve's result bit
    for bit."""
    from bayesian_coresets_tpu_torch.ops import graphs
    gc.collect()
    both = [_graph_consts("int8", "giga", cuda_device, seed=seed) for seed in (1, 2)]
    for i, c in enumerate(both):
        s = snnls.build(c, snnls.init_state(c, 256), 40, 1e-6)
        size = int(s.size)
        idcs = torch.zeros(64, dtype=torch.int32, device=cuda_device)
        idcs[:size] = s.idcs[:size]
        caps = graphs.captures
        out, ok = snnls.optimize_active(c, s, idcs, size, 1e-6)
        assert graphs.captures - caps == (1 if i == 0 else 0)
        w, xw, done, ok2 = snnls._optimize_core(c, s.w, s.xw, s.done, idcs, size, 1e-6, 512)
        torch.cuda.synchronize()
        assert torch.equal(out.w.view(torch.int32), w.view(torch.int32))
        assert torch.equal(out.xw.view(torch.int32), xw.view(torch.int32))
        assert bool(out.done) == bool(done) and bool(ok) == bool(ok2)


@pytest.mark.cuda
def test_dropping_the_constants_of_a_shape_frees_its_set(cuda_device, monkeypatch):
    """Once every constants of a shape is gone, the static copies and their
    graph sets are retired, not freed; past the budget the next set made
    evicts them, and ``release()`` frees them: the memory falls back to
    where it was before them."""
    warm = _graph_consts("int8", "giga", cuda_device, n=2000)   # the stream's own state
    snnls.build(warm, snnls.init_state(warm, 256), 70, 1e-6)
    del warm
    gc.collect()
    graphs.release()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    for evict in (False, True):
        a, b = (_graph_consts("int8", "giga", cuda_device, seed=seed) for seed in (1, 2))
        key = (graphs._stream(a.V.device), graphs.layout(tuple(a)))
        for c in (a, b):
            snnls.build(c, snnls.init_state(c, 256), 70, 1e-6)
        assert len(graphs._statics[key].users) == 2 and graphs._statics[key].sets
        del a, c
        gc.collect()
        assert key in graphs._statics and key not in graphs._retired
        del b
        gc.collect()
        assert key in graphs._statics and list(graphs._retired) == [key]
        assert graphs.retained_bytes == graphs._statics[key].nbytes() > 0
        if evict:
            monkeypatch.setattr(graphs, "RETAINED_SHARE", 0.0)
            other = _graph_consts("int8", "giga", cuda_device, n=1000)
            snnls.build(other, snnls.init_state(other, 256), 10, 1e-6)
            assert key not in graphs._statics and not graphs._retired
            del other
            gc.collect()
            monkeypatch.undo()
        graphs.release()
        torch.cuda.synchronize()
        assert key not in graphs._statics and graphs.retained_bytes == 0
        assert torch.cuda.memory_allocated() == mem


@pytest.mark.cuda
def test_int8_resident_constants_capture_their_own(cuda_device):
    """int8-resident constants of one shape keep sets of their own: the
    second captures again, and each equals its one-iteration build."""
    from bayesian_coresets_tpu_torch.ops import graphs
    for seed in (1, 2):
        c = _graph_consts("int8_resident", "giga", cuda_device, seed=seed)
        ref = snnls.build(c, snnls.init_state(c, 256), 150, 1e-6, segment=1)
        caps = graphs.captures
        _same_state(snnls.build(c, snnls.init_state(c, 256), 150, 1e-6), ref)
        assert graphs.captures > caps


def _grid_walk(c, segment=None):
    """A GIGA ``build`` over the increments of ``coreset_size_grid(500, 7,
    "log")``, as a driver walks it, from a fresh state; the graphs it
    captured."""
    from bayesian_coresets_tpu_torch.experiments.cli import coreset_size_grid
    Ms = coreset_size_grid(500, 7, "log").tolist()
    s, caps = snnls.init_state(c, 1024), graphs.captures
    for k in [Ms[0]] + [b - a for a, b in zip(Ms, Ms[1:])]:
        s = snnls.build(c, s, k, 1e-6, matvec_k=1024, segment=segment)
    torch.cuda.synchronize()
    return s, graphs.captures - caps


def _phase6_consts(dev, seed):
    """Constants of phase 6's shape (N=100k, S=500, int8 select) from a
    random projection seeded ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((500, 100_000), generator=g, device=dev)
    A *= torch.rand(100_000, generator=g, device=dev) + 0.2
    return snnls.make_consts(A, A.sum(dim=1), select_dtype=torch.int8)


@pytest.mark.cuda
def test_log_grid_walks_capture_at_most_14_graphs(cuda_device):
    """A build walked over a driver's log grid up to 500 at phase 6's shape
    captures at most 14 graphs; a second walk on a fresh projection
    captures none, after the first's constants died too; each equals its
    one-iteration walk bit for bit."""
    caps = []
    for seed in (3, 4):
        c = _phase6_consts(cuda_device, seed)
        out, n = _grid_walk(c)
        caps.append(n)
        ref, _ = _grid_walk(c, segment=1)
        _same_state(out, ref)
        assert int(out.itr) == 499
        del c
        gc.collect()
    assert 0 < caps[0] <= 14 and caps[1] == 0
    assert graphs.revivals >= 1


@pytest.mark.cuda
def test_a_layout_whose_constants_died_captures_nothing(cuda_device):
    """Builds on constants of a layout whose constants all died replay its
    retired sets: no capture, a copy-in, the one-iteration build bit for
    bit."""
    c = _graph_consts("int8", "giga", cuda_device, seed=1)
    snnls.build(c, snnls.init_state(c, 256), 150, 1e-6)
    del c
    gc.collect()
    assert len(graphs._retired) == 1
    c = _graph_consts("int8", "giga", cuda_device, seed=2)
    revivals, loads, caps = graphs.revivals, graphs.loads, graphs.captures
    out = snnls.build(c, snnls.init_state(c, 256), 150, 1e-6)
    assert graphs.captures == caps and graphs.revivals == revivals + 1
    assert graphs.loads == loads + 1 and not graphs._retired
    _same_state(out, snnls.build(c, snnls.init_state(c, 256), 150, 1e-6, segment=1))


@pytest.mark.cuda
def test_generators_alternate_through_one_uniform_set(cuda_device):
    """Two generators A, B, A through one uniform-sampling set: each build
    is its direct build bit for bit, each generator ends where the direct
    build leaves it, and only the first captures."""
    c = _graph_consts("int8", "uniform", cuda_device)
    gens = {k: torch.Generator(device=cuda_device).manual_seed(seed) for k, seed in (("a", 5), ("b", 6))}
    refs = {k: torch.Generator(device=cuda_device).manual_seed(seed) for k, seed in (("a", 5), ("b", 6))}
    caps = []
    for k in ("a", "b", "a"):
        before = graphs.captures
        out = snnls.build(c, snnls.init_state(c, 512), 150, 1e-6, method="uniform",
                          draws=gens[k])
        caps.append(graphs.captures - before)
        ref = snnls.build(c, snnls.init_state(c, 512), 150, 1e-6, method="uniform",
                          draws=refs[k], segment=1)
        _same_state(out, ref)
        assert not bool(out.done)
        assert torch.equal(gens[k].get_state(), refs[k].get_state())
    assert caps[0] > 0 and caps[1:] == [0, 0]


@pytest.mark.cuda
def test_eviction_frees_the_evicted_copies(cuda_device, monkeypatch):
    """Two retired layouts within the budget; a budget that holds one evicts
    the older at the next build, and ``memory_allocated`` falls by its
    static copies and buffers at least."""
    for n in (3000, 3001):
        c = _graph_consts("int8", "giga", cuda_device, n=n)
        snnls.build(c, snnls.init_state(c, 256), 70, 1e-6)
        del c
        gc.collect()
    old, new = list(graphs._retired)
    size = graphs._retired[old][1]
    probe = (torch.zeros(1, device=cuda_device),)        # the next set's anchor and buffer
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    monkeypatch.setattr(graphs, "RETAINED_SHARE", (graphs.retained_bytes - 1)
                        / torch.cuda.get_device_properties(cuda_device).total_memory)
    graphs.graphs_for(probe, ("probe",), None, lambda: probe)
    torch.cuda.synchronize()
    assert old not in graphs._statics and list(graphs._retired) == [new]
    assert mem - torch.cuda.memory_allocated() >= size


# ------------------------------------------- NUTS as replayed CUDA graphs

NUTS_COV = [[2.0, 1.2, 0.0], [1.2, 1.5, 0.3], [0.0, 0.3, 0.5]]


def _same_tensors(a, b):
    """Nested results equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            a, b = a.contiguous().view(torch.int32 if a.element_size() == 4 else torch.int64), \
                b.contiguous().view(torch.int32 if b.element_size() == 4 else torch.int64)
        assert torch.equal(a, b)
        return
    for x, y in zip(a, b, strict=True):
        _same_tensors(x, y)


def _nuts_pair(fn, dev, **kw):
    """``fn(gen, graphs)`` replayed and direct, each from a fresh generator:
    both results and both generators' states after."""
    out = []
    for graphs in (None, False):
        gen = torch.Generator(device=dev).manual_seed(7)
        out.append((fn(gen, graphs), gen.get_state()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dense,pooled,segment", [
    (False, False, None), (False, False, 2), (False, False, 4), (True, False, None),
    (False, True, None), (True, True, 4)])
def test_replayed_nuts_equals_direct(dense, pooled, segment, cuda_device):
    """run_nuts through replayed graphs against the direct transitions
    (graphs=False) on the card: samples, acceptance, divergences, step
    sizes, metrics and depths bit for bit (through a metric window and its
    boundary), and the generator left at the same place."""
    from bayesian_coresets_tpu_torch.ops import graphs
    prec = torch.linalg.inv(torch.tensor(NUTS_COV, device=cuda_device))
    logp = lambda th: -0.5 * torch.sum((th @ prec) * th, dim=-1)  # noqa: E731
    init = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32),
                           device=cuda_device)
    caps = graphs.captures
    (rep, g1), (ref, g2) = _nuts_pair(lambda gen, gr: mcmc.run_nuts(
        logp, init, gen, num_warmup=150, num_samples=20, max_depth=6, pooled_adaptation=pooled,
        dense_mass=dense, segment=segment, graphs=gr), cuda_device)
    torch.cuda.synchronize()
    assert graphs.captures > caps
    _same_tensors(rep, ref)
    assert torch.equal(g1, g2)


def _logistic_coreset(dev, n=2000, d=5, m=64, seed=0):
    from bayesian_coresets_tpu_torch.models import logistic
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = logistic.gen_synthetic(gen, n, d)
    idx = torch.randperm(n, generator=gen, device=dev)[:m]
    return z[idx], torch.full((m,), n / m, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["logistic", "f64_island", "dense", "poisson", "max_depth"])
def test_replayed_weighted_run_equals_direct(case, cuda_device):
    """mcmc.weighted.run (the Laplace-preconditioned density, the f64
    island, the dense metric, the Poisson model, a max_depth cut that most
    trees reach) replayed against direct, bit for bit."""
    from bayesian_coresets_tpu_torch.mcmc import weighted
    from bayesian_coresets_tpu_torch.models import logistic, poisson
    model = logistic
    if case == "poisson":
        model = poisson
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        zc = poisson.gen_synthetic(gen, 2000)[:64]
        wc = torch.full((64,), 2000 / 64, device=cuda_device)
    else:
        zc, wc = _logistic_coreset(cuda_device)
    cut = case == "max_depth"
    kw = dict(num_chains=32, num_warmup=40, max_depth=2 if cut else 8, d=zc.shape[1] - 1
              if case == "poisson" else None, f64_logdensity=case == "f64_island",
              dense_mass=case == "dense", target_accept=0.99 if cut else 0.8)
    (rep, g1), (ref, g2) = _nuts_pair(lambda gen, gr: weighted.run(
        model, zc, wc, 20, gen, graphs=gr, **kw), cuda_device)
    _same_tensors(rep[0], ref[0])
    _same_tensors(rep[2], ref[2])
    assert torch.equal(g1, g2)
    if cut:
        assert float(ref[2].tree_depth.max()) == 2.0


@pytest.mark.cuda
def test_replayed_nuts_captures_are_bounded(cuda_device):
    """The graphs a run captures do not grow with its transitions: at most
    the start, the merge, one per doubling index and one per segment
    length (segments of 4 leaves: lengths 1, 2 and 4)."""
    from bayesian_coresets_tpu_torch.ops import graphs
    prec = torch.linalg.inv(torch.tensor(NUTS_COV, device=cuda_device))
    logp = lambda th: -0.5 * torch.sum((th @ prec) * th, dim=-1)  # noqa: E731
    counts = []
    for n in (10, 60):
        caps = graphs.captures
        mcmc.run_nuts(logp, torch.zeros((16, 3), device=cuda_device),
                      torch.Generator(device=cuda_device).manual_seed(2), num_warmup=n,
                      num_samples=n, max_depth=8, segment=4)
        counts.append(graphs.captures - caps)
    assert 0 < counts[0] <= counts[1] <= 2 + 8 + 3, counts


@pytest.mark.cuda
def test_replayed_nuts_reads_only_its_flags(cuda_device):
    """Once its graphs exist, a replayed transition synchronizes only where
    it reads a flag (``nuts.host_reads``)."""
    prec = torch.linalg.inv(torch.tensor(NUTS_COV, device=cuda_device))
    vg = integrators.value_and_grad(lambda th: -0.5 * torch.sum((th @ prec) * th, dim=-1))
    z = torch.zeros((32, 3), device=cuda_device)
    st = integrators.IntegratorState(z, torch.zeros_like(z), *vg(z))
    kern = mcmc.Transitions(vg, torch.Generator(device=cuda_device).manual_seed(0), 6, 2)
    step, im = torch.full((32,), 0.3, device=cuda_device), torch.ones((32, 3), device=cuda_device)
    for _ in range(30):
        st, _ = kern(st, step, im)
    torch.cuda.synchronize()
    reads = nuts.host_reads
    (st, info), syncs = _syncs(lambda: kern(st, step, im))
    assert len(syncs) == nuts.host_reads - reads, syncs


@pytest.mark.cuda
def test_cpu_generator_with_cuda_chains_raises(cuda_device):
    z = torch.zeros((4, 2), device=cuda_device)
    for graphs in (None, False):
        with pytest.raises(ValueError, match="chains' device"):
            mcmc.run_nuts(_gauss_logp(cuda_device), z, torch.Generator(), num_warmup=2,
                          num_samples=2, graphs=graphs)
    with pytest.raises(ValueError, match="graphs=False"):
        mcmc.run_nuts(_gauss_logp(cuda_device), z, _CpuDraws(torch.Generator()),
                      num_warmup=2, num_samples=2)


@pytest.mark.cuda
def test_replayed_weighted_run_on_the_main_coreset(cuda_device):
    """weighted NUTS on the main path's coreset (bench.py's flagship build:
    N=100k, D=10, S=500, int8 select, M=500), 256 chains x (30 + 30):
    replayed and direct, bit for bit."""
    from bayesian_coresets_tpu_torch.mcmc import weighted
    from bayesian_coresets_tpu_torch.models import logistic
    n, d = 100_000, 10
    Z = logistic.gen_synthetic(torch.Generator(device=cuda_device).manual_seed(0), n, d)
    proj = bc.BlackBoxProjector(
        lambda g, k, w, p: 0.1 * torch.randn((k, d), generator=g, device=g.device), 500,
        logistic.log_likelihood, generator=torch.Generator(device=cuda_device).manual_seed(1))
    c = bc.HilbertCoreset(Z, proj, select_dtype=torch.int8, max_active=1024)
    c.build(500)
    wts, pts, _ = c.get()
    zc, wc = torch.as_tensor(pts, device=cuda_device), torch.as_tensor(wts, device=cuda_device)
    (rep, g1), (ref, g2) = _nuts_pair(lambda gen, gr: weighted.run(
        logistic, zc, wc, 30, gen, num_chains=256, target_accept=0.8, num_warmup=30,
        graphs=gr), cuda_device)
    _same_tensors(rep[0], ref[0])
    _same_tensors(rep[2], ref[2])
    assert torch.equal(g1, g2)


# ---------------------------------------------------------------------------
# SparseVI's and BatchPSVI's Adam steps as replayed CUDA graphs (ops/opt.py)
# ---------------------------------------------------------------------------


def _logistic_problem(dev, n=2000, d=6, S=64):
    """Logistic data and the logistic_poisson driver's black-box family
    with its warm Laplace refit (``laplace_refits``)."""
    from bayesian_coresets_tpu_torch.experiments.logistic_poisson import laplace_refits
    from bayesian_coresets_tpu_torch.models import logistic
    Z = logistic.gen_synthetic(torch.Generator(device=dev).manual_seed(5), n, d)
    sampler, warm, init = laplace_refits(logistic, d, dev)
    fam = bc.coresets.blackbox_family(sampler, S, logistic.log_likelihood,
                                      logistic.grad_z_log_likelihood, warm_sampler=warm,
                                      init_carry=init)
    return Z, fam


def _linreg_blackbox(dev):
    """The linear_regression driver's black-box family: samples of the
    QR refit of the coreset's weighted posterior."""
    from bayesian_coresets_tpu_torch.models import linreg
    z, _ = _linreg_exact(dev)
    d = z.shape[1] - 1
    mu0, S0 = torch.zeros(d, device=dev), torch.eye(d, device=dev)

    def sampler(g, n, w, p):
        if p.numel() == 0:
            w, p = torch.zeros(1, device=dev), torch.zeros((1, d + 1), device=dev)
        return linreg.sample_weighted_post(g, mu0, S0, 0.7, p, w, n)

    return z, bc.coresets.blackbox_family(sampler, 32, lambda p, th: linreg.log_likelihood(
        p, th, 0.7), lambda p, th: linreg.grad_x_log_likelihood(p, th, 0.7))


def _svi_family(kind, dev):
    if kind == "exact":
        return _svi_problem(dev)
    if kind == "basis":
        return _svi_problem(dev)[0], _bb_family(dev, 12)
    if kind == "linreg":
        return _linreg_blackbox(dev)
    return _logistic_problem(dev)


def _same_tensors_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["exact", "basis", "logistic", "linreg"])
def test_svi_replayed_equals_direct(kind, cuda_device):
    """SparseVI through replayed graphs (segments of 10 of 23 steps: two
    whole ones and a tail of 3) against ``graphs=False``: weights, indices,
    size, points and the generator's state bit for bit, after a build from
    empty, a build resumed from that coreset and ``optimize()``; the
    second build replays the first's graphs."""
    from bayesian_coresets_tpu_torch.ops import graphs
    x, fam = _svi_family(kind, cuda_device)
    out = {}
    for mode in (False, None):
        c = bc.SparseVICoreset(x, fam, opt_itrs=23, capacity=16, seed=3, graphs=mode,
                               segment=10, n_subsample_select=256, n_subsample_opt=256)
        steps = []
        for act in (lambda: c.build(4), lambda: c.build(3), c.optimize):
            caps = graphs.captures
            act()
            steps.append((c._wts.clone(), c._idcs.clone(), c._size, c._gen.get_state(),
                          graphs.captures - caps))
        out[mode] = steps, c.get()
    (ref, (rw, rp, ri)), (rep, (w, p, i)) = out[False], out[None]
    for a, b in zip(rep, ref):
        _same_tensors_bits(a[0], b[0])
        assert torch.equal(a[1], b[1]) and a[2] == b[2] and torch.equal(a[3], b[3])
    assert [r[4] for r in ref] == [0, 0, 0]
    assert rep[0][4] >= 1 and rep[1][4] == 0 and rep[2][4] == 0
    assert np.array_equal(w.view(np.int32), rw.view(np.int32)) and np.array_equal(i, ri)
    assert np.array_equal(np.asarray(p, np.float32).view(np.int32),
                          np.asarray(rp, np.float32).view(np.int32))
    assert 3 <= ri.size <= 7 and np.isfinite(rw).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["basis", "logistic"])
def test_bpsvi_replayed_equals_direct(kind, cuda_device):
    """BatchPSVI through replayed graphs (segments of 10 of 23 steps)
    against ``graphs=False``, three times on one facade (the first build
    captures the whole segment, the second the tail, the third replays
    only): weights, points and the generator's state bit for bit."""
    from bayesian_coresets_tpu_torch.ops import graphs
    x, fam = (_svi_problem(cuda_device)[0], _bb_family(cuda_device, 12)) if kind == "basis" \
        else _logistic_problem(cuda_device)
    out = {}
    for mode in (False, None):
        c = bc.BatchPSVICoreset(x, fam, opt_itrs=23, n_subsample_opt=256, seed=2,
                                graphs=mode, segment=10)
        runs = []
        for _ in range(3):
            caps = graphs.captures
            c.build(6)
            runs.append((c.wts, c.pts, c._gen.get_state(), graphs.captures - caps))
        out[mode] = runs
    for a, b in zip(out[None], out[False]):
        assert np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))
        assert torch.equal(a[2], b[2])
    assert [r[3] for r in out[None]] == [1, 1, 0] and [r[3] for r in out[False]] == [0, 0, 0]
    assert np.isfinite(out[None][2][0]).all() and (out[None][2][0] >= 0).all()


@pytest.mark.cuda
def test_nn_opt_segments_replayed_equal_direct(cuda_device):
    """nn_opt alone, uncached: every segment length replayed against the
    direct steps, bit for bit, with a carried state and fresh draws."""
    t = torch.as_tensor(np.random.default_rng(3).normal(size=64).astype(np.float32),
                        device=cuda_device)

    def grad_fn(x, g, aux):
        return x - t + 0.1 * torch.randn(x.shape, generator=g, device=g.device), aux + x

    def run(graphs, segment):
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        x, aux = nn_opt(torch.zeros(64, device=cuda_device), grad_fn, gen, opt_itrs=37,
                        aux0=torch.zeros(64, device=cuda_device), graphs=graphs,
                        segment=segment)
        return x, aux, gen.get_state()

    ref = run(False, 1)
    for segment in (1, 5, 10, 37, 50):
        x, aux, st = run(None, segment)
        _same_tensors_bits(x, ref[0])
        _same_tensors_bits(aux, ref[1])
        assert torch.equal(st, ref[2])


_EIGH_CAPTURE = """
import sys
import torch
sys.path.insert(0, "tests")
from test_torch_cuda import _linreg_exact
from bayesian_coresets_tpu_torch.coresets import sparsevi
dev = torch.device("cuda")
x, exact = _linreg_exact(dev)


def make_ctx(gen, wts, pts):            # a refit through an eigh, which reads
    mu, F = exact.make_ctx(gen, wts, pts)   # its error code back to the host
    lam, U = torch.linalg.eigh(F.T @ F)
    return mu, (U * torch.sqrt(lam)) @ U.T


fam = exact._replace(make_ctx=make_ctx)
try:
    sparsevi.svi_build(x, torch.zeros(4, device=dev),
                       torch.full((4,), -1, dtype=torch.int64, device=dev), 0,
                       torch.Generator(device=dev), 2, family=fam, n_sub_sel=None,
                       n_sub_opt=None, opt_itrs=20, step_sched=lambda i: 1.0 / (1.0 + i),
                       segment=5)
except RuntimeError as e:
    print("capture raised:", str(e)[:200])
    sys.exit(3)
"""


@pytest.mark.cuda
def test_a_failed_adam_capture_raises(cuda_device):
    """No fallback: a gradient that reads the host runs its first segment
    (the warm-up) and raises at its capture; a family whose refit takes an
    eigh is such a family (a stand-in: the linear-regression exact family
    with an eigh of its factor's Gram), which would need graphs=False.  Its
    capture runs in a process of its own: a cuSOLVER call that failed
    inside a capture leaves the process's handle unusable
    (CUSOLVER_STATUS_EXECUTION_FAILED at the next eigh)."""
    import subprocess
    import sys
    from pathlib import Path
    t = torch.ones(8, device=cuda_device)

    def grad_fn(x, g):
        return x - t * float(x.sum() > -1.0)

    with pytest.raises(RuntimeError):
        nn_opt(torch.zeros(8, device=cuda_device), grad_fn,
               torch.Generator(device=cuda_device), opt_itrs=20, segment=5)
    with pytest.raises(ValueError, match="graphs=False"):
        nn_opt(torch.zeros(8), grad_fn, torch.Generator(), opt_itrs=4, graphs=True)
    with pytest.raises(ValueError, match="torch.Generator"):
        nn_opt(torch.zeros(8, device=cuda_device), grad_fn, torch.Generator(), opt_itrs=4)
    r = subprocess.run([sys.executable, "-c", _EIGH_CAPTURE], capture_output=True, text=True,
                       cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert r.returncode == 3 and "capture raised" in r.stdout, r.stdout + r.stderr[-2000:]


def _linreg_exact(dev, n=400, d=6):
    from bayesian_coresets_tpu_torch.models import linreg
    rng = np.random.default_rng(8)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ np.arange(1, d + 1) + rng.normal(size=n)).astype(np.float32)
    z = torch.as_tensor(np.hstack([X, y[:, None]]), device=dev)
    bV = torch.linalg.eigh(z[:, :-1].T @ z[:, :-1])[1][:, -3:].contiguous()
    return z, bc.linreg_tangent_family(torch.zeros(d, device=dev), torch.eye(d, device=dev),
                                       1.0, bV)


@pytest.mark.cuda
def test_linreg_exact_svi_replays_as_direct(cuda_device):
    """The linear-regression exact family's low-rank refit reads nothing
    (a matrix square root by Cholesky factors, no eigh), so its Adam steps
    replay CUDA graphs as every other family's: replayed (twice, the second
    on the cached graphs) against ``graphs=False``, bit for bit on the
    weights, the slots' points and the generator's state; the only host
    reads, direct or on cached graphs, are the select's one flag per
    select, and the refit makes none while the graphs are captured."""
    x, fam = _linreg_exact(cuda_device)
    selects, steps = 3, 17
    out, gen = [], torch.Generator(device=cuda_device)
    for mode in (False, None, None):
        gen.manual_seed(5)              # one generator: the graphs are cached per generator
        caps = graphs.captures
        (w, i, size), syncs = _syncs(lambda: sparsevi.svi_build(      # 4 slots <= d = 6
            x, torch.zeros(4, device=cuda_device),
            torch.full((4,), -1, dtype=torch.int64, device=cuda_device), 0, gen, selects,
            family=fam, n_sub_sel=None, n_sub_opt=None, opt_itrs=steps,
            step_sched=lambda i: 1.0 / (1.0 + i), graphs=mode, segment=5))
        out.append((w, x[i.clamp_min(0)], gen.get_state(), graphs.captures - caps))
        assert 0 < size <= selects and bool(torch.isfinite(w).all())
        flags = [s for s in syncs if "coresets/sparsevi.py" in s]
        assert len(flags) == selects and not any("models/linreg.py" in s for s in syncs)
        if len(out) != 2:               # not the run that captures the graphs
            assert flags == syncs, syncs
    for run in out[1:]:
        _same_tensors_bits(run[0], out[0][0])
        _same_tensors_bits(run[1], out[0][1])
        assert torch.equal(run[2], out[0][2])
    assert out[0][3] == 0 and out[1][3] > 0 and out[2][3] == 0, [r[3] for r in out]


@pytest.mark.cuda
def test_refits_read_nothing_on_the_card(cuda_device):
    """The posterior refits on SparseVI's and BatchPSVI's steps make no
    synchronizing call (sync debug mode "error"), after a first call has
    made cuSOLVER's handle; a factor that fails is NaN, as on the CPU."""
    from bayesian_coresets_tpu_torch.models import laplace, linreg, logistic
    dev = cuda_device
    rng = np.random.default_rng(9)
    z = torch.as_tensor(rng.normal(size=(50, 4)).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, size=50).astype(np.float32), device=dev)
    eye = torch.eye(4, device=dev)
    g = torch.Generator(device=dev)
    calls = {
        "laplace": lambda: laplace.laplace_approx(z, w, torch.zeros(4, device=dev),
                                                  logistic.grad_th_log_joint,
                                                  logistic.hess_th_log_joint, num_iters=3),
        "gaussian_post": lambda: gaussian.weighted_post(torch.zeros(4, device=dev), eye, eye,
                                                        z, w),
        "gaussian_sample": lambda: gaussian.sample_weighted_post(
            g, torch.zeros(4, device=dev), eye, eye, z, w, 16),
        "linreg_post": lambda: linreg.weighted_post(torch.zeros(3, device=dev), eye[:3, :3],
                                                    1.0, z, w),
        "linreg_sample": lambda: linreg.sample_weighted_post(
            g, torch.zeros(3, device=dev), eye[:3, :3], 1.0, z, w, 16),
        "linreg_lowrank": lambda: linreg.weighted_post_lowrank(
            linreg.lowrank_basis(torch.zeros(3, device=dev), eye[:3, :3], 1.0), z[:3], w[:3]),
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    bad = laplace.laplace_approx(z, w, torch.zeros(4, device=dev), logistic.grad_th_log_joint,
                                 lambda z, th, w: -logistic.hess_th_log_joint(z, th, w))
    assert bool(torch.isnan(bad.mu).all()) and bool(torch.isnan(bad.USig).all())


# ---------------------------------------------------------------------------
# The experiment drivers' Adam steps on the card
# ---------------------------------------------------------------------------


_DRIVER_ADAM = {
    "poisson": ["--model", "poiss", "--dataset", "synth_poiss", "--mcmc_samples_full", "32",
                "--mcmc_samples_coreset", "32", "--mcmc_chains", "2", "--proj_dim", "32",
                "--fs_samples", "16", "--max_treedepth", "8", "--ess_gate", "1"],
    "linear_regression": ["--data_num", "1200", "--n_bases_per_scale", "5",
                          "--proj_dim", "30"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("driver,alg", [("poisson", "SVI"), ("poisson", "BPSVI"),
                                        ("linear_regression", "SVI")])
def test_driver_adam_steps_replay_without_host_reads(driver, alg, cuda_device, tmp_path,
                                                     monkeypatch):
    """``logistic_poisson --model poiss`` (its warm Laplace refits; BatchPSVI
    with the whole row's gradient, ROADMAP Queue 3 (m)) and
    ``linear_regression --alg SVI`` (the QR refit of the black-box sampler)
    on the card through their ``main``: every Adam step runs, the steps
    replay graphs, and the segments that run directly (each key's first,
    before its capture) make no synchronizing call."""
    from bayesian_coresets_tpu_torch.experiments import linear_regression, logistic_poisson
    from bayesian_coresets_tpu_torch.ops import graphs, opt
    monkeypatch.chdir(tmp_path)
    main = logistic_poisson.main if driver == "poisson" else linear_regression.main
    if driver == "poisson":
        monkeypatch.setenv("BC_DATA_DIR", write_poisson(str(tmp_path / "data"), 400, 100))
    seg, reads, direct = opt._segment, [], [0]

    def counted(grad_fn, gen, hyper, n, s, p):
        if torch.cuda.is_current_stream_capturing():
            return seg(grad_fn, gen, hyper, n, s, p)
        out, syncs = _syncs(lambda: seg(grad_fn, gen, hyper, n, s, p))
        reads.extend(syncs)
        direct[0] += n
        return out

    monkeypatch.setattr(opt, "_segment", counted)
    opt.steps_run, caps = 0, graphs.captures
    main(["run", "--alg", alg, "--coreset_size_max", "6", "--coreset_num_sizes", "2",
          "--opt_itrs", "25"] + _DRIVER_ADAM[driver])
    want = 25 * (6 if alg == "SVI" else 2)     # 6 selects; BatchPSVI's sizes 1 and 6
    assert opt.steps_run == want and reads == [], (opt.steps_run, reads)
    assert graphs.captures > caps and 0 < direct[0] < want


def _span_coreset(dev, chunk=None, seed=5, n=20_000, S=256):
    """A Hilbert coreset on the card of logistic rows held on the host, each
    seed its own projection; ``chunk``: streamed into int8-resident
    constants, whose graphs each build captures anew."""
    from bayesian_coresets_tpu_torch.models import logistic
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 10)).astype(np.float32)
    th = torch.as_tensor(0.1 * rng.normal(size=(S, 10)), dtype=torch.float32, device=dev)
    proj = bc.BlackBoxProjector(lambda gen, k, w, p: th, S, logistic.log_likelihood,
                                generator=torch.Generator(device=dev))
    if chunk is not None:
        return bc.HilbertCoreset(z, proj, stream_chunk_size=chunk, max_active=1024, device=dev)
    return bc.HilbertCoreset(z, proj, select_dtype=torch.int8, max_active=1024, device=dev)


@pytest.mark.cuda
def test_traced_capturing_build_records_no_event_in_a_capture(cuda_device, monkeypatch):
    """A replayed build on int8-resident constants (it captures its graphs)
    with the program's tracing on: none of the recorder's events is
    recorded inside a stream capture, a span opened inside one gets no
    device interval, and the answer is the untraced build's bit for bit."""
    from bayesian_coresets_tpu_torch.utils import profiling
    off = _span_coreset(cuda_device, chunk=6000)
    off.build(300)
    mine, capturing = set(), []
    take, record = profiling._event, torch.cuda.Event.record

    def event(idx):
        ev = take(idx)
        mine.add(id(ev))
        return ev

    def recorded(ev, stream=None):
        if id(ev) in mine:
            capturing.append(torch.cuda.is_current_stream_capturing())
        return record(ev, stream)

    monkeypatch.setattr(profiling, "_event", event)
    monkeypatch.setattr(torch.cuda.Event, "record", recorded)
    x = torch.ones(4, device=cuda_device)

    def work():
        with profiling.span("inside.capture", device=cuda_device):
            x.mul_(2.0)

    caps = graphs.captures
    profiling.reset()
    profiling.enable()
    try:
        on = _span_coreset(cuda_device, chunk=6000)
        on.build(300)
        graphs.Graph(work, graphs.side_stream(cuda_device),
                     torch.cuda.graph_pool_handle()).replay()
        recs = profiling.spans()
    finally:
        profiling.disable()
        profiling.reset()
    assert graphs.captures - caps >= 2
    names = [r["name"] for r in recs]
    assert names.count("graphs.capture") >= 1 and names.count("graphs.replay") >= 5
    assert capturing and not any(capturing)
    inside = [r for r in recs if r["name"] == "inside.capture"]
    assert len(inside) == 1 and inside[0]["dev_start"] is None
    assert all(r["dev_start"] is not None for r in recs if r["name"] != "inside.capture")
    (w0, p0, i0), (w1, p1, i1) = off.get(), on.get()
    assert np.array_equal(i0, i1) and np.array_equal(p0, p1)
    assert np.array_equal(w0.view(np.uint8), w1.view(np.uint8))
    assert off.error() == on.error()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 6000], ids=["shared", "int8_resident"])
def test_span_device_intervals_lie_inside_their_host_spans(chunk, cuda_device):
    """Two traced builds: each build's replayed pieces take no more device
    time than its ``hilbert.solve``, and every device interval starts after
    its host span started and ends before the next synchronize (a read's
    interval before the read returned)."""
    from bayesian_coresets_tpu_torch.utils import profiling
    tol = 2e-4          # the reference event's pairing with the host clock
    profiling.reset()
    profiling.enable()
    try:
        for seed in (5, 6):
            _span_coreset(cuda_device, chunk, seed=seed).build(300)
        torch.cuda.synchronize()
        t_sync = time.perf_counter()
        recs = profiling.spans()
    finally:
        profiling.disable()
        profiling.reset()
    for r in recs:
        assert r["dev_start"] is not None, r["name"]
        assert r["host_start"] - tol <= r["dev_start"] <= r["dev_end"] <= t_sync + tol, r
        if r["name"] in ("snnls.read", "hilbert.active"):
            assert r["dev_end"] <= r["host_end"] + tol, r
    solves = [i for i, r in enumerate(recs) if r["name"] == "hilbert.solve"]
    assert len(solves) == 2
    for i in solves:
        s = recs[i]
        replays = [r for r in recs if r["name"] == "graphs.replay" and r["parent"] == i]
        assert len(replays) >= 5
        inside = sum(r["dev_end"] - r["dev_start"] for r in replays)
        assert 0 < inside <= s["dev_end"] - s["dev_start"]


# ------------------------------ the fused GIGA step (ops/giga_step.py)


def _same_work(a, b):
    for name in a._fields:
        assert torch.equal(gsc.bits(getattr(a, name)), gsc.bits(getattr(b, name))), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", gsc.CASES)
def test_giga_step_kernels_match_plain(name, cuda_device):
    """One fused iteration from the states that decide each branch: the two
    kernels against their plain versions on the card, bit for bit (state,
    directions and the step's work), one update and two directions
    launches."""
    p, c = gsc.on(*gsc.case(name), cuda_device)
    before = gst.launches, gst.dirs_launches
    out, work = gsc.fused(p, c, plain=False)
    torch.cuda.synchronize()
    assert (gst.launches - before[0], gst.dirs_launches - before[1]) == (1, 2)
    ref, ref_work = gsc.fused(p, c, plain=True)
    gsc.assert_same(out, ref)
    _same_work(work, ref_work)
    gsc.assert_case(name, c, out, work)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "int8_resident"])
def test_replayed_fused_build_at_20k_matches_cpu(kind, cuda_device):
    """A replayed 500-iteration build at N=20k, S=500 (f32 V with an int8
    select, or int8-resident V): the atoms and weights of the CPU build, at
    test_build_on_card_matches_cpu's tolerances, one fused step per
    iteration run."""
    from bayesian_coresets_tpu_torch.parallel import quantize_chunk
    rng = np.random.default_rng(6)
    A = torch.as_tensor(rng.normal(size=(500, 20_000)).astype(np.float32))
    A *= torch.as_tensor(rng.uniform(0.2, 3.0, size=20_000).astype(np.float32))
    if kind == "float32":
        c_cpu = snnls.make_consts(A, A.sum(dim=1), select_dtype=torch.int8)
    else:
        q, nrm, bsum = quantize_chunk(A.T.contiguous(), A.shape[1])
        c_cpu = snnls.make_consts_quantized(q, nrm, bsum.float())
    # the CPU's constants on the card: the norms and the int8 copy made on
    # the card sum in another order
    c_gpu = snnls.SNNLSConsts(*(t.to(cuda_device) for t in c_cpu))
    s_cpu = snnls.build(c_cpu, snnls.init_state(c_cpu, 1024), 500, 1e-6)
    before, ran, sel = gst.launches, snnls.itrs_run, gs.launches
    s_gpu = snnls.build(c_gpu, snnls.init_state(c_gpu, 1024), 500, 1e-6)
    assert gst.launches - before == snnls.itrs_run - ran == gs.launches - sel >= int(s_gpu.itr)
    k = int(s_cpu.size)
    assert int(s_gpu.itr) == int(s_cpu.itr) > 400 and int(s_gpu.size) == k
    np.testing.assert_array_equal(s_gpu.idcs[:k].cpu().numpy(), s_cpu.idcs[:k].numpy())
    np.testing.assert_allclose(s_gpu.w.cpu().numpy(), s_cpu.w.numpy(), rtol=1e-4, atol=1e-6)


def _graph_nodes(fn, dev):
    """The nodes of the CUDA graph captured from ``fn()`` (run once on the
    capture stream first), counted by libcuda's ``cuGraphGetNodes``."""
    import ctypes
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream(dev).wait_stream(s)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=s):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()),
                                                       None, ctypes.byref(n))
    assert err == 0
    return n.value


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int8_resident"])
def test_fused_iteration_is_at_most_four_graph_nodes(kind, cuda_device):
    """Captured segments of 1, 2 and 8 non-refresh GIGA iterations: each
    iteration adds 4 nodes (the select, the update, the fold, the finish),
    and a segment one more (its first directions)."""
    c = _graph_consts(kind, "giga", cuda_device)
    s = snnls.build(c, snnls.init_state(c, 256), 10, 1e-6)
    p = snnls._Problem(c, "giga", 1e-6, 256, None, None, None, None, None)
    carry = snnls._carry(c, s, 1000)
    carry = carry._replace(**{k: t.clone() for k, t in carry.state()._asdict().items()})
    nodes = [_graph_nodes(lambda m=m: snnls._segment(p, carry, m, False), cuda_device)
             for m in (1, 2, 8)]
    assert nodes[1] - nodes[0] == (nodes[2] - nodes[1]) // 6 <= 4 and nodes[0] <= 5, nodes


@pytest.mark.cuda
def test_giga_step_launches_count_the_giga_iterations(cuda_device):
    """Replayed builds: the update kernel launches once per GIGA iteration
    run (replays counted), as the select does; Frank-Wolfe, OMP and the
    sampling solvers, and GIGA without slots, never launch it."""
    for method, K in (("giga", 256), ("giga", 0), ("frankwolfe", 256), ("orthopursuit", 256),
                      ("uniform", 256)):
        c = _graph_consts("int8", method, cuda_device)
        before, ran, dirs = gst.launches, snnls.itrs_run, gst.dirs_launches
        snnls.build(c, snnls.init_state(c, K), 70 if method != "orthopursuit" else 12, 1e-6,
                    method=method, draws=_gen(cuda_device, method))
        fused = method == "giga" and K > 0
        assert gst.launches - before == (snnls.itrs_run - ran if fused else 0), method
        # and the directions once per iteration and once per piece
        assert (gst.dirs_launches - dirs > gst.launches - before if fused
                else gst.dirs_launches == dirs), method
