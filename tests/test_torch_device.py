"""Where the PyTorch port puts its work, and what it builds from.

- The port builds the exact NNLS solver from its own copy of ``nnls.cpp``,
  byte for byte the JAX package's, and no module of the port names the JAX
  package's directory as a path.
- ``pyproject.toml`` packages every kernel source and header and the NNLS
  source, so an installed port can build them.
- The entry points put numpy data on the default device: the CUDA card, or
  the CPU after ``set_default_device("cpu")``; without a card and without
  that call they raise.  A tensor stays where the caller put it, and a
  tensor on another device than the data raises.

This file imports no JAX and needs no card.
"""

import ast
import fnmatch
import re
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import bayesian_coresets_tpu_torch as bc
from bayesian_coresets_tpu_torch import native
from bayesian_coresets_tpu_torch.models import gaussian, logistic
from bayesian_coresets_tpu_torch.ops import giga_select as gs
from bayesian_coresets_tpu_torch.ops import snnls
from bayesian_coresets_tpu_torch.utils import config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "bayesian_coresets_tpu_torch"
N, D, S = 40, 3, 8


@pytest.fixture
def default_device():
    """Restores the default device after the test."""
    yield
    config.set_default_device(None)


def test_nnls_source_is_the_ports_own_copy():
    assert native.SOURCE.resolve().is_relative_to(PORT)
    jax_src = ROOT / "bayesian_coresets_tpu" / "native" / "nnls.cpp"
    assert native.SOURCE.read_bytes() == jax_src.read_bytes()


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


def test_no_port_module_names_the_jax_package_as_a_path():
    """No string in the port's code (docstrings aside, which cite the JAX
    package's files for reference) names the JAX package's directory."""
    jax_dir = re.compile(r"bayesian_coresets_tpu(?!_torch)")
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs and jax_dir.search(node.value)):
                found.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not found, found


def test_pyproject_packages_every_kernel_and_native_source():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = meta["tool"]["setuptools"]["package-data"]["bayesian_coresets_tpu_torch"]
    sources = [*PORT.glob("csrc/*.cu"), *PORT.glob("csrc/*.cuh"), *PORT.glob("native/*.cpp")]
    assert {p.suffix for p in sources} == {".cu", ".cuh", ".cpp"}
    missing = [str(p.relative_to(PORT)) for p in sources
               if not any(fnmatch.fnmatch(str(p.relative_to(PORT)), g) for g in globs)]
    assert not missing, missing


def test_default_device_raises_without_a_card_unless_cpu_is_set(monkeypatch, default_device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_default_device(None)
    with pytest.raises(RuntimeError, match="set_default_device"):
        config.default_device()
    with pytest.raises(RuntimeError, match="set_default_device"):
        bc.snnls.GIGA(np.ones((4, 3), np.float32), np.ones(4, np.float32))
    bc.set_default_device("cpu")
    assert bc.default_device() == torch.device("cpu")


def _x():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


def _sampler(g, n, w, p):
    return 0.1 * torch.randn((n, D), generator=g, device=g.device)


def _gaussian_projector(device=None):
    eye = torch.eye(D)
    return bc.BlackBoxProjector(
        _sampler, S, lambda p, th: gaussian.log_likelihood(p, th, eye.to(p.device), 0.0),
        grad_loglikelihood=lambda p, th: gaussian.grad_x_log_likelihood(p, th, eye.to(p.device)),
        device=device)


def _devices(name, data):
    """The devices an entry point put its work on, given ``data``."""
    if name == "HilbertCoreset":
        c = bc.HilbertCoreset(data, bc.BlackBoxProjector(_sampler, S, logistic.log_likelihood,
                                                         device="cpu"))
        return [c.data.device, c.snnls.consts.V.device]
    if name == "SparseVICoreset":
        c = bc.SparseVICoreset(data, _gaussian_projector("cpu"), opt_itrs=2)
        return [c.data.device, c._gen.device]
    if name == "BatchPSVICoreset":
        c = bc.BatchPSVICoreset(data, _gaussian_projector("cpu"), opt_itrs=2)
        return [c.data.device, c._gen.device]
    if name == "UniformSamplingCoreset":
        c = bc.UniformSamplingCoreset(data, seed=1)
        c.build(5)
        return [c.data.device]
    if name == "GIGA":
        A = data.T if isinstance(data, torch.Tensor) else np.ascontiguousarray(data.T)
        g = bc.snnls.GIGA(A, A.sum(1))
        return [g.consts.V.device, g.state.w.device]
    if name == "BlackBoxProjector":
        p = bc.BlackBoxProjector(_sampler, S, logistic.log_likelihood)
        return [p.device, p._gen.device, p.samples.device]
    assert name == "FamilyProjector"
    p = bc.FamilyProjector(bc.identity_tangent_family())
    return [p.device, p._gen.device]


ENTRY_POINTS = ["HilbertCoreset", "SparseVICoreset", "BatchPSVICoreset",
                "UniformSamplingCoreset", "GIGA", "BlackBoxProjector", "FamilyProjector"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_numpy_data_goes_to_the_cpu_when_it_is_the_default(name, default_device):
    bc.set_default_device("cpu")
    assert set(_devices(name, _x())) == {torch.device("cpu")}


@pytest.mark.parametrize("name", ["HilbertCoreset", "SparseVICoreset", "BatchPSVICoreset",
                                  "UniformSamplingCoreset", "GIGA"])
def test_a_cpu_tensor_stays_on_the_cpu(name, default_device):
    """With another default device set, a CPU tensor still stays put."""
    bc.set_default_device("meta")
    assert set(_devices(name, torch.as_tensor(_x()))) == {torch.device("cpu")}


def test_mismatched_devices_raise(default_device):
    bc.set_default_device("cpu")
    A = np.abs(_x()).T.copy()
    with pytest.raises(ValueError, match="on meta"):
        snnls.GIGA(torch.as_tensor(A), torch.zeros(A.shape[0], device="meta"))
    proj = bc.BlackBoxProjector(_sampler, S, logistic.log_likelihood)
    with pytest.raises(ValueError, match="on meta"):
        proj.project(torch.zeros((N, D), device="meta"))
    with pytest.raises(ValueError, match="generator on cpu"):
        bc.BlackBoxProjector(_sampler, S, logistic.log_likelihood,
                             generator=torch.Generator(), device="meta")
    c = snnls.make_consts(torch.as_tensor(A), torch.as_tensor(A.sum(1)), select_dtype=torch.int8)
    with pytest.raises(ValueError, match="must be on"):
        gs.giga_select(c.Vsel, torch.zeros((A.shape[0], 2), device="meta"), c.norms, c.valid)
