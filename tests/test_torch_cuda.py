"""CUDA-only checks of the PyTorch port: the hand-written select kernel
against its plain PyTorch version, and a GIGA build on the card against the
same build on the CPU.

Every test here needs a card and skips without one.  This file imports no
JAX, so it also runs where JAX is absent; there, skip the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from bayesian_coresets_tpu_torch.ops import giga_select as gs
from bayesian_coresets_tpu_torch.ops import snnls
from bayesian_coresets_tpu_torch.utils import interop

torch.set_num_threads(1)

DTYPES = [torch.int8, torch.bfloat16, torch.float32]
CASES = ["random", "invalid_block", "all_invalid", "ties"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU route)")
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
