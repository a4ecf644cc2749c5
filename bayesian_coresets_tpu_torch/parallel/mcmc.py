"""Chains sharded over the ranks of a mesh.

Port of ``bayesian_coresets_tpu/parallel/mcmc.py``.  There the chains'
vmapped batch dimension carries a sharding and XLA turns the pooled
adaptation's means into collectives; here each rank runs its block of the
chains through :func:`..mcmc.sample.run_nuts` with the chain axis's
exchanges (``comm=``), which gathers what pooled adaptation reads and the
results at the end.
"""

from __future__ import annotations

from ..mcmc.sample import MCMCResult, run_nuts
from .comm import Comm
from .mesh import CHAIN_AXIS, Mesh


def chain_comm(mesh: Mesh, num_chains: int) -> Comm:
    """The exchanges of this rank's block of ``num_chains`` chains over the
    mesh's chain axis (else its first axis, as the JAX package picks)."""
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must come from parallel.make_mesh; got {type(mesh).__name__}")
    axis = CHAIN_AXIS if CHAIN_AXIS in mesh.axis_names else mesh.axis_names[0]
    world = mesh.axis_size(axis)
    if num_chains % world:
        raise ValueError(f"num_chains ({num_chains}) must be a multiple of the "
                         f"{axis!r} axis ({world})")
    return Comm(mesh, axis, num_chains // world)


def run_nuts_sharded(logdensity_fn, init_params, gen, mesh: Mesh,
                     num_warmup: int = 1000, num_samples: int = 1000,
                     max_depth: int = 10, target_accept: float = 0.8,
                     pooled_adaptation: bool = False,
                     dense_mass: bool = False) -> MCMCResult:
    """``run_nuts`` with the chains split over the mesh's chain axis
    (collective: every rank calls it with the same arguments).

    ``init_params`` (num_chains, d) holds every chain's start, num_chains a
    multiple of the axis size; each rank samples its contiguous block.
    ``logdensity_fn`` is batched over a block's chains; ``gen`` starts alike
    on every rank.  ``pooled_adaptation=True`` shares the step size and the
    metric across all chains.  Returns all chains' result on every rank.
    """
    comm = chain_comm(mesh, init_params.shape[0])
    block = init_params[comm.lo:comm.lo + comm.n_loc]
    return run_nuts(logdensity_fn, block, gen, num_warmup=num_warmup,
                    num_samples=num_samples, max_depth=max_depth,
                    target_accept=target_accept, pooled_adaptation=pooled_adaptation,
                    dense_mass=dense_mass, comm=comm)
