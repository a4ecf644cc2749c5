// The global first-max argmax shared by the select kernels.
//
// Blocks on Hopper run in parallel and in no order, so a block reduces its
// rows to one packed 64-bit key and folds it into a device-wide maximum with
// one atomicMax (stream_rows.cuh's finish); the last block to finish decodes
// the key.  The key holds the order-preserving bits of the score high and
// 0xFFFFFFFF - row low, so a larger key is a larger score, then a lower row:
// ties go to the lowest row, as jnp.argmax and torch.argmax give.  A zero
// key is below every real key; all rows at -inf decode to (row 0, -inf).
//
// Everything here has internal linkage: each kernel source includes its own
// copy, so the library links without duplicate symbols.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long pack_key(float s, long long row) {
  const unsigned int b = __float_as_uint(s);
  const unsigned int u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)u << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned int)row);
}

__device__ __forceinline__ void decode_key(unsigned long long k, int* __restrict__ idx,
                                           float* __restrict__ score) {
  const unsigned int u = (unsigned int)(k >> 32);
  const unsigned int b = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  *idx = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
  *score = __uint_as_float(b);
}

}  // namespace
