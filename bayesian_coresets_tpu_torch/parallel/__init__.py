"""Parallel and streamed construction: meshes over ``torch.distributed``
ranks (one or several axes), Hilbert builds sharded by rows (in memory and
streamed int8-resident) and by projection columns, chains sharded over
ranks, and the streamed int8-resident quantization.  SparseVI and
BatchPSVI shard their data rows through ``mesh=`` on their facades.

Port of ``bayesian_coresets_tpu/parallel/`` (the reference is
single-process, SURVEY.md §2.5).  JAX's collectives are inserted by XLA
from sharding annotations; here one process drives one GPU and every
exchange is an explicit ``all_reduce`` (:mod:`.comm`) over one axis's
process group.
"""

from .comm import Comm, Ledger
from .coreset import (build_sharded, build_sharded_quantized, make_sharded_consts,
                      shard_consts, shard_state, sharded_comm)
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
    "sharded_comm",
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
