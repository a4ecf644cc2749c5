// Packed-int4 select for Hopper (sm_90a): a bandwidth probe of GIGA's select.
//
// Replaces scripts/probe_int4_pallas.py::packed_select (the Pallas TPU
// kernel _packed_select_kernel).  It computes exactly what that kernel
// computes, unnormalized dequantization constant included:
//
//   per row r of the (n, S/2) packed copy P (byte j holds original column
//   2j in its low nibble and 2j+1 in its high nibble, both signed 4-bit):
//     (a0, a1) = lo(P[r]) . q[0::2]  +  hi(P[r]) . q[1::2]      int32
//        q = clip(round(127 * dirs2), -127, 127)  the int8 directions (S, 2)
//     (d0, d1) = f32(a) * f32(1/(7*127)) * nrminv[r]
//     score = d0 / sqrt(clip(1 - d1^2, 1e-30)) + bias[r]      (no geo_ok guard)
//   result: the lowest row of the maximal score, and that score.
//
// What bounds it on the H100: bytes.  One call streams the packed copy once
// (N=2^20, S=512: 256 MiB, half of the int8 copy kernel 1 reads) for 8
// integer multiply-adds per byte.  What the design does about it:
//   - kernel 1's skeleton: lanes load 16 contiguous bytes each, rows in a
//     grid-stride loop, the score epilogue and argmax in registers, one
//     packed 64-bit atomicMax per block (select_key.cuh);
//   - a row of S/2 bytes is C = S/32 16-byte chunks; it gets the smallest
//     power of two G >= C lanes (at most 32), so a warp takes 32/G rows at
//     once and no lane idles at S=512 (C = G = 16, two rows per warp);
//   - the nibbles are never widened: (w << 4) & 0xF0F0F0F0 and
//     w & 0xF0F0F0F0 leave each signed nibble in the high half of its byte,
//     i.e. 16x its value as an int8 lane, which __dp4a takes as it is.  The
//     int32 sums are then exactly 16x the dots (|dot| <= S*7*127, far from
//     overflow), and an arithmetic shift by 4 gives the dots exactly.
// The score epilogue uses the _rn intrinsics so that FMA contraction cannot
// change its rounding against the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "select_key.cuh"

namespace {

constexpr int kWarps = 8;                       // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 8;
// f32 rounding of the probe's weakly typed constant 1/(7*127)
constexpr float kInv7x127 = (float)(1.0 / (7.0 * 127.0));
constexpr unsigned int kHiNibbles = 0xF0F0F0F0u;

// 16 packed bytes (32 original columns) against the matching 16 bytes of
// the four direction vectors [lo0, lo1, hi0, hi1], accumulated as 16x dots.
__device__ __forceinline__ void packed_chunk_dot(int4 v, int4 l0, int4 l1, int4 h0,
                                                 int4 h1, int& a0, int& a1) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  const int pl0[4] = {l0.x, l0.y, l0.z, l0.w};
  const int pl1[4] = {l1.x, l1.y, l1.z, l1.w};
  const int ph0[4] = {h0.x, h0.y, h0.z, h0.w};
  const int ph1[4] = {h1.x, h1.y, h1.z, h1.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int lo = (int)(((unsigned int)w[k] << 4) & kHiNibbles);
    const int hi = (int)((unsigned int)w[k] & kHiNibbles);
    a0 = __dp4a(lo, pl0[k], a0);
    a0 = __dp4a(hi, ph0[k], a0);
    a1 = __dp4a(lo, pl1[k], a1);
    a1 = __dp4a(hi, ph1[k], a1);
  }
}

__global__ void __launch_bounds__(kThreads)
packed_select_kernel(const int4* __restrict__ P, long long n, int chunks, int group_log2,
                     const int4* __restrict__ dirs, const float* __restrict__ nrminv,
                     const float* __restrict__ bias, unsigned long long* __restrict__ key) {
  __shared__ unsigned long long warp_best[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = 1 << group_log2;            // lanes per row
  const int sub = lane & (group - 1);           // lane within its row's group
  const int rows_per_warp = 32 >> group_log2;
  const long long stride = (long long)gridDim.x * kWarps * rows_per_warp;
  unsigned long long best = 0ull;               // below every real key
  // the loop bounds are uniform across the warp, so every lane reaches the
  // shuffles; a lane past the last row adds zeros and keeps no key
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * rows_per_warp;
       base < n; base += stride) {
    const long long row = base + (lane >> group_log2);
    int a0 = 0, a1 = 0;
    if (row < n) {
      const int4* pr = P + row * chunks;
      for (int c = sub; c < chunks; c += group) {
        packed_chunk_dot(pr[c], __ldg(dirs + c), __ldg(dirs + chunks + c),
                         __ldg(dirs + 2 * chunks + c), __ldg(dirs + 3 * chunks + c),
                         a0, a1);
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xFFFFFFFFu, a0, off);
      a1 += __shfl_xor_sync(0xFFFFFFFFu, a1, off);
    }
    if (sub == 0 && row < n) {
      // a >> 4 is exact (a is a multiple of 16); int32 -> f32 is exact while
      // |dot| < 2^24
      const float nr = nrminv[row];
      const float d0 = __fmul_rn(__fmul_rn((float)(a0 >> 4), kInv7x127), nr);
      const float d1 = __fmul_rn(__fmul_rn((float)(a1 >> 4), kInv7x127), nr);
      const float om = __fsub_rn(1.0f, __fmul_rn(d1, d1));
      const float cl = om < 1e-30f ? 1e-30f : om;   // NaN passes, as in jnp.clip
      float s = __fadd_rn(__fdiv_rn(d0, __fsqrt_rn(cl)), bias[row]);
      if (s == 0.0f) s = 0.0f;                  // -0 ties +0, as in argmax
      const unsigned long long k = pack_key(s, row);
      best = k > best ? k : best;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    best = o > best ? o : best;
  }
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = warp_best[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = warp_best[w] > m ? warp_best[w] : m;
    if (m) atomicMax(key, m);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  P: (n, row_bytes) packed int8
// rows, 16-byte aligned, row_bytes % 16 == 0 (zero bytes past S/2 add
// nothing); dirs: (4, row_bytes) int8 rows [lo0, lo1, hi0, hi1], the even
// and odd rows of the quantized directions, zero-padded alike; nrminv,
// bias: (n,) f32; key: one uint64 zeroed by the caller; idx/score: one int32
// / one f32.  Launches on `stream`, never synchronizes, returns
// cudaGetLastError().
extern "C" int packed_select_launch(const void* P, long long n, long long row_bytes,
                                    const void* dirs, const void* nrminv,
                                    const void* bias, void* key, void* idx, void* score,
                                    void* stream) {
  if (n <= 0 || row_bytes <= 0 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (int)(row_bytes / 16);
  int group_log2 = 0;
  while ((1 << group_log2) < chunks && group_log2 < 5) ++group_log2;
  const long long rows_per_block = (long long)kWarps * (32 >> group_log2);
  const long long want = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)sms * kBlocksPerSM;
  const int blocks = (int)(want < cap ? want : cap);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned long long* k = reinterpret_cast<unsigned long long*>(key);
  packed_select_kernel<<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const int4*>(P), n, chunks, group_log2,
      reinterpret_cast<const int4*>(dirs), reinterpret_cast<const float*>(nrminv),
      reinterpret_cast<const float*>(bias), k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_finish<<<1, 1, 0, s>>>(k, reinterpret_cast<int*>(idx),
                                reinterpret_cast<float*>(score));
  return (int)cudaGetLastError();
}
