"""Parallel and streamed construction.  On one device so far: the streamed
int8-resident quantization (:mod:`.streamed`).  Meshes, sharded builds and
sharded chains are ROADMAP item 16."""

from .streamed import quantize_chunk, round_up

__all__ = ["quantize_chunk", "round_up"]
