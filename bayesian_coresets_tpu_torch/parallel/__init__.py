"""Parallel and streamed construction: meshes over ``torch.distributed``
ranks, row-sharded Hilbert builds (in memory and streamed int8-resident),
chains sharded over ranks, and the streamed int8-resident quantization.

Port of ``bayesian_coresets_tpu/parallel/`` (the reference is
single-process, SURVEY.md §2.5).  JAX's collectives are inserted by XLA
from sharding annotations; here one process drives one GPU and every
exchange is an explicit ``all_reduce`` (:mod:`.comm`).  Sharding the
projection axis is ROADMAP item 16b.
"""

from .comm import Comm, Ledger
from .coreset import (build_sharded, build_sharded_quantized, make_sharded_consts,
                      shard_consts, shard_state)
from .distributed import initialize, local_data_shard
from .launch import run_local
from .mcmc import run_nuts_sharded
from .mesh import CHAIN_AXIS, DATA_AXIS, PROJ_AXIS, Mesh, make_mesh
from .streamed import (make_streamed_quantized_consts, quantize_chunk, round_up,
                       stream_quantized, streamed_row_layout)

__all__ = [
    "make_mesh",
    "Mesh",
    "DATA_AXIS",
    "PROJ_AXIS",
    "CHAIN_AXIS",
    "Comm",
    "Ledger",
    "build_sharded",
    "build_sharded_quantized",
    "make_sharded_consts",
    "shard_consts",
    "shard_state",
    "run_nuts_sharded",
    "initialize",
    "local_data_shard",
    "run_local",
    "make_streamed_quantized_consts",
    "quantize_chunk",
    "round_up",
    "stream_quantized",
    "streamed_row_layout",
]
