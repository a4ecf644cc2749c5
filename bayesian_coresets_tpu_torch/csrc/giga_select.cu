// GIGA select for Hopper (sm_90a): fused scores + global first-max argmax.
//
// Replaces bayesian_coresets_tpu/ops/pallas_kernels.py::giga_select_pallas
// (the Pallas TPU kernel _giga_select_kernel).  It computes the same thing,
// with the JAX package's default-select rounding (ops/snnls.py:479-487):
//
//   per row r of the (n, Sp) selection copy Vsel:
//     (d0, d1) = Vsel[r] . [cdir_n, xw_n]
//        int8:     int32 dot of the int8 row against the int8-quantized
//                  directions, times f32(1/127^2) (rows are pre-normalized)
//        bf16/f32: f32 accumulation, then divided by norms[r]
//     geo_ok = d1 > -1 + 1e-14  &&  1 - d1^2 > 0
//     score  = geo_ok ? d0 / sqrt(max(1 - d1^2, 1e-30)) : 0;  -inf if !valid[r]
//   result: the lowest index of the maximal score, and that score
//   (all rows invalid -> index 0, score -inf, as jnp.argmax gives).
//
// What bounds it on the H100: bytes.  Each GIGA iteration streams the whole
// selection copy once (N=100k, S=500: 51 MB of int8; N=1M: 512 MB) for
// 4 integer multiply-adds per byte, far below the card's compute rate.
// What the design does about it:
//   - one warp per row, every lane loading 16 contiguous bytes per step, so
//     a warp reads 512 contiguous bytes (a whole S=500 int8 row) at once;
//   - int8 dots on the CUDA cores with __dp4a (4 MACs per instruction); the
//     2-column product never touches a matrix unit;
//   - the (n, 2) dots and (n,) scores never reach device memory: the score
//     epilogue and the argmax run in registers;
//   - a grid-stride loop over rows with one packed 64-bit atomicMax per
//     block (order-preserving score bits high, 0xFFFFFFFF - index low, so
//     the lowest index wins ties), then a one-thread kernel decodes it.
//     The TPU kernel's sequential running accumulator has no counterpart:
//     blocks on Hopper run in parallel and in no order.
// The score epilogue uses the _rn intrinsics so that FMA contraction
// cannot change its rounding against the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;                       // rows in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 8;                 // 2048 threads: full occupancy
// f32 rounding of 1/127^2, as the JAX package's weakly typed constant
constexpr float kInv127Sq = (float)(1.0 / (127.0 * 127.0));

enum SelectDtype { kInt8 = 0, kBf16 = 1, kF32 = 2 };

// Dots of one 16-byte chunk of a row against the same chunk of both
// directions, accumulated into (a0, a1).
__device__ __forceinline__ void chunk_dot(int4 v, int4 p, int4 q, int& a0, int& a1) {
  a0 = __dp4a(v.x, p.x, a0); a0 = __dp4a(v.y, p.y, a0);
  a0 = __dp4a(v.z, p.z, a0); a0 = __dp4a(v.w, p.w, a0);
  a1 = __dp4a(v.x, q.x, a1); a1 = __dp4a(v.y, q.y, a1);
  a1 = __dp4a(v.z, q.z, a1); a1 = __dp4a(v.w, q.w, a1);
}

__device__ __forceinline__ void chunk_dot_bf16(int4 v, int4 p, int4 q, float& a0, float& a1) {
  const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&p);
  const __nv_bfloat162* qq = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(vv[i]);
    const float2 y = __bfloat1622float2(pp[i]);
    const float2 z = __bfloat1622float2(qq[i]);
    a0 = fmaf(x.x, y.x, a0); a0 = fmaf(x.y, y.y, a0);
    a1 = fmaf(x.x, z.x, a1); a1 = fmaf(x.y, z.y, a1);
  }
}

__device__ __forceinline__ void chunk_dot_f32(int4 v, int4 p, int4 q, float& a0, float& a1) {
  const float4 x = *reinterpret_cast<const float4*>(&v);
  const float4 y = *reinterpret_cast<const float4*>(&p);
  const float4 z = *reinterpret_cast<const float4*>(&q);
  a0 = fmaf(x.x, y.x, a0); a0 = fmaf(x.y, y.y, a0);
  a0 = fmaf(x.z, y.z, a0); a0 = fmaf(x.w, y.w, a0);
  a1 = fmaf(x.x, z.x, a1); a1 = fmaf(x.y, z.y, a1);
  a1 = fmaf(x.z, z.z, a1); a1 = fmaf(x.w, z.w, a1);
}

// Order-preserving map of a float onto uint32, packed with the inverted
// row index: a larger key is a larger score, then a lower index.
__device__ __forceinline__ unsigned long long pack_key(float s, long long row) {
  const unsigned int b = __float_as_uint(s);
  const unsigned int u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)u << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned int)row);
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
giga_select_kernel(const int4* __restrict__ V, long long n, int chunks,
                   const int4* __restrict__ dirs, const float* __restrict__ norms,
                   const unsigned char* __restrict__ valid,
                   unsigned long long* __restrict__ key) {
  using Acc = typename std::conditional<DT == kInt8, int, float>::type;
  __shared__ unsigned long long warp_best[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long best = 0ull;               // below every real key
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < n; row += stride) {
    const int4* vr = V + row * chunks;
    Acc a0 = 0, a1 = 0;
    for (int c = lane; c < chunks; c += 32) {
      const int4 v = vr[c];
      const int4 p = __ldg(dirs + c);
      const int4 q = __ldg(dirs + chunks + c);
      if constexpr (DT == kInt8) chunk_dot(v, p, q, a0, a1);
      else if constexpr (DT == kBf16) chunk_dot_bf16(v, p, q, a0, a1);
      else chunk_dot_f32(v, p, q, a0, a1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xFFFFFFFFu, a0, off);
      a1 += __shfl_xor_sync(0xFFFFFFFFu, a1, off);
    }
    if (lane == 0) {
      float d0, d1;
      if constexpr (DT == kInt8) {
        // int32 -> f32 rounds to nearest, as astype(float32) does (exact
        // while |dot| < 2^24, i.e. for every Sp < 1040)
        d0 = __fmul_rn((float)a0, kInv127Sq);
        d1 = __fmul_rn((float)a1, kInv127Sq);
      } else {
        const float nr = norms[row];
        d0 = __fdiv_rn(a0, nr);
        d1 = __fdiv_rn(a1, nr);
      }
      const float om = __fsub_rn(1.0f, __fmul_rn(d1, d1));
      // f32(-1 + 1e-14) == -1.0f
      const bool geo_ok = (d1 > -1.0f) && (om > 0.0f);
      float s = geo_ok ? __fdiv_rn(d0, __fsqrt_rn(fmaxf(om, 1e-30f))) : 0.0f;
      if (!valid[row]) s = __int_as_float(0xff800000);   // -inf
      if (s == 0.0f) s = 0.0f;                  // -0 ties +0, as in argmax
      const unsigned long long k = pack_key(s, row);
      best = k > best ? k : best;
    }
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

__global__ void giga_select_finish(const unsigned long long* __restrict__ key,
                                   int* __restrict__ idx, float* __restrict__ score) {
  const unsigned long long k = *key;
  const unsigned int u = (unsigned int)(k >> 32);
  const unsigned int b = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  *idx = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
  *score = __uint_as_float(b);
}

}  // namespace

// Plain C entry point (bound with ctypes).  V: (n, row_bytes / elem) rows,
// 16-byte aligned, row_bytes % 16 == 0; dirs: (2, same) in V's dtype;
// norms: (n,) f32 (unused for int8); valid: (n,) bool; key: one uint64
// zeroed by the caller; idx/score: one int32 / one f32.  Launches on
// `stream`, never synchronizes, returns cudaGetLastError().
extern "C" int giga_select_launch(const void* V, int dtype, long long n,
                                  long long row_bytes, const void* dirs,
                                  const void* norms, const void* valid, void* key,
                                  void* idx, void* score, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * kBlocksPerSM;
  const int blocks = (int)(want < cap ? want : cap);
  const int chunks = (int)(row_bytes / 16);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* v4 = reinterpret_cast<const int4*>(V);
  const int4* d4 = reinterpret_cast<const int4*>(dirs);
  const float* nr = reinterpret_cast<const float*>(norms);
  const unsigned char* ok = reinterpret_cast<const unsigned char*>(valid);
  unsigned long long* k = reinterpret_cast<unsigned long long*>(key);
  switch (dtype) {
    case kInt8: giga_select_kernel<kInt8><<<blocks, kThreads, 0, s>>>(v4, n, chunks, d4, nr, ok, k); break;
    case kBf16: giga_select_kernel<kBf16><<<blocks, kThreads, 0, s>>>(v4, n, chunks, d4, nr, ok, k); break;
    case kF32: giga_select_kernel<kF32><<<blocks, kThreads, 0, s>>>(v4, n, chunks, d4, nr, ok, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  giga_select_finish<<<1, 1, 0, s>>>(k, reinterpret_cast<int*>(idx),
                                     reinterpret_cast<float*>(score));
  return (int)cudaGetLastError();
}
