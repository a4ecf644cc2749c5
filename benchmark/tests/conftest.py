"""Fixtures of the benchmark's own tests: cells of BENCHMARK.json cut to toy
sizes for the CPU, and the card where there is one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cpu():
    import torch
    torch.set_num_threads(2)      # the tests run in several workers at once
    return torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while
    the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
