"""Shared CLI plumbing for experiment drivers.

Port of ``bayesian_coresets_tpu/experiments/cli.py``: the same parsers,
subcommands, flags and defaults (reference examples/gaussian/main.py:223-264,
with a named registry of step schedules instead of ``eval``'d lambda
strings), so the same argv gives the same namespace and results key.  The
``run`` subcommand has one flag more, ``--device {cuda,cpu}`` (default
``cuda``): where the run computes, this package's counterpart of the JAX
package's ``JAX_PLATFORMS``.  It is left out of the results key.

``--data_mesh k`` and ``--chain_mesh`` shard a run over the ranks of a
process group, one process per GPU: start it with ``torchrun
--nproc-per-node k -m bayesian_coresets_tpu_torch.experiments.<driver> run
...`` (NCCL; gloo with ``--device cpu``).  Rank 0 alone writes the results.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import CHAIN_AXIS, DATA_AXIS, initialize, make_mesh
from ..utils import config
from . import plotting, results


def step_sched(spec: str):
    """Named step schedules: 'inv' -> 1/(1+i), 'invsqrt' -> 1/sqrt(1+i),
    'const:<v>' -> v, 'inv:<a>' -> a/(1+i)."""
    if spec == "inv":
        return lambda i: 1.0 / (1.0 + i)
    if spec == "invsqrt":
        return lambda i: 1.0 / (1.0 + i) ** 0.5
    if spec.startswith("const:"):
        v = float(spec.split(":", 1)[1])
        return lambda i: v
    if spec.startswith("inv:"):
        a = float(spec.split(":", 1)[1])
        return lambda i: a / (1.0 + i)
    raise ValueError(f"unknown step schedule {spec!r} "
                     "(use inv | invsqrt | const:<v> | inv:<a>)")


def plot_command(arguments):
    """Generic plot subcommand (reference gaussian/main.py:15-27)."""
    to_match = dict(vars(arguments))
    for nm in (arguments.summarize or []):
        to_match.pop(nm, None)
    if arguments.plot_legend:
        to_match.pop(arguments.plot_legend, None)
    table = results.load_matching(to_match)
    if table is None:
        print("No matching results to plot, skipping")
        return
    out = plotting.plot(arguments, table)
    print(f"wrote {out}")


class _SharedArgs:
    """Proxy that registers experiment args on every subparser, so both
    ``run --alg X`` and ``plot ... --alg X`` accept them."""

    def __init__(self, parser, subs):
        self._parser = parser
        self._subs = subs

    def add_argument(self, *a, **k):
        for s in self._subs:
            s.add_argument(*a, **k)

    def parse_args(self, argv=None):
        return self._parser.parse_args(argv)

    def error(self, msg):
        self._parser.error(msg)


def make_parser(description: str):
    parser = argparse.ArgumentParser(description=description)
    sub = parser.add_subparsers(help="sub-command help")
    run_p = sub.add_parser("run", help="Runs the main computational code")
    plot_p = sub.add_parser("plot", help="Plots the results")
    plot_p.set_defaults(func=plot_command)

    shared = _SharedArgs(parser, [run_p, plot_p])
    shared.add_argument("--trial", type=int, default=0,
                        help="Trial number (seeds PRNG for replicability)")
    shared.add_argument("--results_folder", type=str, default="results/")
    shared.add_argument("--verbosity", type=str, default="error",
                        choices=["error", "warning", "critical", "info", "debug"])
    run_p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="where the run computes (not part of the results key)")

    plot_p.add_argument("plot_x", type=str)
    plot_p.add_argument("plot_y", type=str)
    plot_p.add_argument("--plot_title", type=str)
    plot_p.add_argument("--plot_x_label", type=str)
    plot_p.add_argument("--plot_y_label", type=str)
    plot_p.add_argument("--plot_x_type", choices=["linear", "log"], default="log")
    plot_p.add_argument("--plot_y_type", choices=["linear", "log"], default="log")
    plot_p.add_argument("--plot_legend", type=str)
    plot_p.add_argument("--plot_type", choices=["line", "scatter"], default="scatter")
    plot_p.add_argument("--plot_out", type=str, help="Output image path")
    plot_p.add_argument("--summarize", type=str, nargs="*")
    plot_p.add_argument("--groupby", type=str)
    return shared, run_p, plot_p


# --select_dtype -> the selection copy's dtype (None: select on V itself)
SELECT_DTYPES = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _group(arguments, driver: str, flag: str, k) -> None:
    """Join the process group that ``torchrun`` started (NCCL for ``--device
    cuda``, gloo for ``--device cpu``), or raise with the command that
    starts one.  A group already up (e.g. ``parallel.run_local``) is used
    as it is."""
    if dist.is_initialized():
        return
    if "RANK" not in os.environ:
        raise RuntimeError(
            f"{flag} runs as one rank of a process group; start every rank with: torchrun "
            f"--nproc-per-node {k} -m bayesian_coresets_tpu_torch.experiments.{driver} "
            f"run {flag} ...")
    initialize(backend="gloo" if arguments.device == "cpu" else "nccl")


def data_mesh(arguments, driver: str):
    """The data-axis mesh of ``--data_mesh k`` (None without the flag): the
    run is one of k ranks (``torchrun --nproc-per-node k``), and the
    Hilbert build shards its rows over them."""
    k = int(getattr(arguments, "data_mesh", 0) or 0)
    if not k:
        return None
    _group(arguments, driver, f"--data_mesh {k}", k)
    return make_mesh({DATA_AXIS: k})


def chain_mesh(arguments, driver: str):
    """The chain-axis mesh of ``--chain_mesh`` over every rank of the
    process group (None without the flag)."""
    if not getattr(arguments, "chain_mesh", False):
        return None
    _group(arguments, driver, "--chain_mesh", "K")
    return make_mesh({CHAIN_AXIS: dist.get_world_size()})


def rank0() -> bool:
    """Whether this process writes shared files (the results store, caches):
    the only process, or rank 0 of a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def dispatch(parser, argv=None):
    """Parse ``argv`` and run its subcommand; ``run`` computes on
    ``--device`` (the default device is restored afterwards) and returns
    what the driver's ``run`` returns."""
    arguments = parser.parse_args(argv)
    if not hasattr(arguments, "func"):
        parser.error("specify a subcommand: run | plot")
    if not hasattr(arguments, "device"):          # plot: host only
        return arguments.func(arguments)
    if arguments.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here; pass --device cpu "
                           "to run on the CPU")
    with config.using_device(arguments.device):
        return arguments.func(arguments)


def coreset_size_grid(size_max: int, num_sizes: int, spacing: str, with_zero=True):
    if spacing == "log":
        Ms = np.unique(np.logspace(0.0, np.log10(size_max), num_sizes, dtype=np.int32))
    else:
        Ms = np.unique(np.linspace(1, size_max, num_sizes, dtype=np.int32))
    if with_zero and Ms[0] != 0:
        Ms = np.hstack((0, Ms))
    return Ms
