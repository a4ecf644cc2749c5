// Packed-int4 select for Hopper (sm_90a): a bandwidth probe of GIGA's select,
// one launch per select.
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
// (N=2^20, S=512: 256 MiB, half of the int8 copy kernel 1 reads, plus 8 MiB
// of nrminv and bias) for 8 integer multiply-adds per byte.  The first
// design (kernel 1's grid-stride skeleton) reached 39% of the HBM rate; it
// also re-read four 16-byte direction chunks from L1 for every 16 bytes of
// data.  This design shares kernel 1's (stream_rows.cuh): a persistent grid,
// a 4-stage TMA ring of 8 KB tiles of whole rows per block, lane groups of
// G = pow2 >= chunks lanes per row (G = 16 at S=512: two rows per warp
// pass), 4 rows per group per step summed by one transposed butterfly, and
// one launch with a ticket finish; nrminv and bias are loaded one step
// ahead.  The four direction rows [lo0, lo1, hi0,
// hi1] are quantized in the kernel, once per block, into shared memory,
// and each lane keeps its chunk of all four in registers for the whole
// kernel when a row fits one pass of its group (every S <= 1024).
// Packed rows past 32 KB take packed_select_wide_kernel below, in the same
// one launch.  It replaces the same TPU kernel (_packed_select_kernel) at
// wide rows and is bound by bytes too (n=4096, S=65568: 134 MB).  At those
// widths a ring tile holds one row, which one warp of eight would compute
// on, and a kernel reading the rows straight from global memory, each lane
// quantizing four direction chunks for every 16 data bytes, reached 18% of
// the bound.  So it streams groups of 8 rows in 4 KB pieces through a TMA
// ring, each lane quantizing its own chunks of the four direction rows in
// the block's first group and keeping them in shared memory, as kernel 1's
// wide-row kernel (stream_rows.cuh's row_groups).
// The nibbles are never widened: (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0
// leave each signed nibble in the high half of its byte, i.e. 16x its value
// as an int8 lane, which __dp4a takes as it is.  The int32 sums are then
// exactly 16x the dots (|dot| <= S*7*127, far from overflow), and an
// arithmetic shift by 4 gives the dots exactly.  At the full HBM rate the
// integer pipe is about half busy, so the arithmetic is not the limit.
// The score epilogue uses the _rn intrinsics so that FMA contraction cannot
// change its rounding against the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_rows.cuh"

namespace {

// f32 rounding of the probe's weakly typed constant 1/(7*127)
constexpr float kInv7x127 = (float)(1.0 / (7.0 * 127.0));
constexpr unsigned int kHiNibbles = 0xF0F0F0F0u;

// Rows past this take the wide-row kernel (a sweep may build other limits)
#ifndef BCT_PACKED_RING_MAX_ROW
#define BCT_PACKED_RING_MAX_ROW (32 * 1024)
#endif
constexpr int kRingMaxRow = BCT_PACKED_RING_MAX_ROW;

struct PackedArgs {
  const unsigned char* P;
  long long n;
  int row_bytes;
  int tile_rows;
  int stages;
  const float* dirs;        // (S, 2) f32, row-major, S = 2 * (unpadded row bytes)
  int S;
  const float* nrminv;
  const float* bias;
  Workspace* ws;
  int* idx;
  float* score;
};

struct Dirs4 {
  int4 l0, l1, h0, h1;
};

// 16 packed bytes (32 original columns) against the matching 16 bytes of
// the four direction rows, accumulated as 16x dots.
__device__ __forceinline__ void packed_chunk_dot(int4 v, const Dirs4& d, int& a0, int& a1) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  const int pl0[4] = {d.l0.x, d.l0.y, d.l0.z, d.l0.w};
  const int pl1[4] = {d.l1.x, d.l1.y, d.l1.z, d.l1.w};
  const int ph0[4] = {d.h0.x, d.h0.y, d.h0.z, d.h0.w};
  const int ph1[4] = {d.h1.x, d.h1.y, d.h1.z, d.h1.w};
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

// round(127 d), half to even, clipped to +-127
__device__ __forceinline__ int quantize_int8(float f) {
  const int q = __float2int_rn(__fmul_rn(f, 127.0f));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

// A row's packed key from its two summed 16x dots and its scalars.
__device__ __forceinline__ unsigned long long row_key(int a0, int a1, float nr, float bi,
                                                      long long row) {
  // a >> 4 is exact (a is a multiple of 16); int32 -> f32 is exact while
  // |dot| < 2^24
  const float d0 = __fmul_rn(__fmul_rn((float)(a0 >> 4), kInv7x127), nr);
  const float d1 = __fmul_rn(__fmul_rn((float)(a1 >> 4), kInv7x127), nr);
  const float om = __fsub_rn(1.0f, __fmul_rn(d1, d1));
  const float cl = om < 1e-30f ? 1e-30f : om;         // NaN passes, as in jnp.clip
  float sc = __fadd_rn(__fdiv_rn(d0, __fsqrt_rn(cl)), bi);
  if (sc == 0.0f) sc = 0.0f;                          // -0 ties +0, as in argmax
  return pack_key(sc, row);
}

// The four direction rows [lo0, lo1, hi0, hi1] of the quantized directions
// (even and odd rows of q), each zero-padded to row_bytes, into shared
// memory, by the consumer warps: every thread loads before it stores.
__device__ __forceinline__ void quantize_dirs4(const float* __restrict__ dirs, int S, int rb,
                                               signed char* dq) {
  constexpr int kStride = kConsumerWarps * 32;
  for (int base = threadIdx.x; base < 4 * rb; base += 4 * kStride) {
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kStride;
      const int r = i / rb;
      const int s = 2 * (i - r * rb) + (r >> 1);    // lo rows: even columns; hi: odd
      f[k] = (i < 4 * rb && s < S) ? dirs[2 * s + (r & 1)] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kStride;
      if (i >= 4 * rb) break;
      dq[i] = (signed char)quantize_int8(f[k]);
    }
  }
}

__device__ __forceinline__ Dirs4 dirs_chunk(const int4* d4, int C, int c) {
  return Dirs4{d4[c], d4[C + c], d4[2 * C + c], d4[3 * C + c]};
}

template <int LOG_G>
__global__ void __launch_bounds__(kThreads) packed_select_kernel(const PackedArgs a) {
  constexpr int U = kRowsPerStep;
  constexpr int G = 1 << LOG_G;
  constexpr int RPW = 32 >> LOG_G;
  constexpr int SR = RPW * U;
  using R = Reduced<LOG_G, U>;

  extern __shared__ __align__(128) unsigned char smem[];
  const int rb = a.row_bytes;
  const int C = rb / 16;
  signed char* dq = reinterpret_cast<signed char*>(smem + kBarBytes);   // (4, rb)
  const Ring ring = ring_setup(smem, smem + kBarBytes + 4 * rb, a.stages, a.tile_rows * rb);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (G - 1);
  const int grp = lane >> LOG_G;
  const int4* d4 = reinterpret_cast<const int4*>(dq);
  const int4 z = make_int4(0, 0, 0, 0);
  Dirs4 first{z, z, z, z};
  if (warp < kConsumerWarps) {                        // meanwhile the producer streams
    quantize_dirs4(a.dirs, a.S, rb, dq);
    consumer_sync();
    if (sub < C) first = dirs_chunk(d4, C, sub);
  }
  const int u0 = value_offset<LOG_G, U>(lane) >> 1;
  const int spt = (a.tile_rows + SR - 1) / SR;
  // Warp w takes the block's steps q = w, w + 8, ...; the per-row scalars
  // of this lane's epilogue rows are loaded one step ahead (as in kernel 1).
  const Span span = block_span(a.n, a.tile_rows);
  float nr_next[R::E], bi_next[R::E];
  const auto prefetch = [&](long long q) {
    const long long t = q / spt;
    const long long row0 = (span.first + t) * a.tile_rows;
#pragma unroll
    for (int e = 0; e < R::E; ++e) {
      const int rl = (int)(q - t * spt) * SR + (u0 + e) * RPW + grp;
      nr_next[e] = 0.0f;
      bi_next[e] = 0.0f;
      if (t < span.count && rl < a.tile_rows && row0 + rl < a.n) {
        nr_next[e] = a.nrminv[row0 + rl];
        bi_next[e] = a.bias[row0 + rl];
      }
    }
  };
  if (warp < kConsumerWarps) prefetch(warp);
  unsigned long long best = 0ull;                     // below every real key

  stream_rows(a.P, a.n, rb, a.tile_rows, ring,
              [&](const unsigned char* buf, long long i, long long row0, int rows) {
    for (int s = (warp - (int)((i * spt) & 7)) & 7; s < spt; s += kConsumerWarps) {
      const int r0 = s * SR;
      if (r0 >= rows) break;
      float nr[R::E], bi[R::E];
#pragma unroll
      for (int e = 0; e < R::E; ++e) {
        nr[e] = nr_next[e];
        bi[e] = bi_next[e];
      }
      prefetch(i * spt + s + kConsumerWarps);
      int v[2 * U];
#pragma unroll
      for (int k = 0; k < 2 * U; ++k) v[k] = 0;
      for (int c = sub; c < C; c += G) {
        const Dirs4 d = c == sub ? first : dirs_chunk(d4, C, c);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int rl = r0 + u * RPW + grp;
          if (rl < rows) {
            const int4 x = reinterpret_cast<const int4*>(buf + (size_t)rl * rb)[c];
            packed_chunk_dot(x, d, v[2 * u], v[2 * u + 1]);
          }
        }
      }
      group_reduce<LOG_G, U>(v, lane);
#pragma unroll
      for (int e = 0; e < R::E; ++e) {
        int a0, a1;
        row_pair<LOG_G, U>(v, lane, e, a0, a1);
        const int rl = r0 + (u0 + e) * RPW + grp;
        if (rl < rows) {
          const unsigned long long key = row_key(a0, a1, nr[e], bi[e], row0 + rl);
          best = key > best ? key : best;
        }
      }
    }
  });
  finish(best, a.ws, a.idx, a.score);
}

// The same select for packed rows past the ring's 32 KB (stream_rows.cuh's
// row_groups, as giga_select_wide_kernel): each lane quantizes its own
// chunks of the four direction rows in the block's first group, as
// quantize_dirs4 does, and keeps them in shared memory for the later groups
// (rows up to 32992 bytes on the H100; wider rows fetch them again in every
// group).  A chunk's 16 packed bytes hold 32 columns: 64 f32 values.
__global__ void __launch_bounds__(kThreads) packed_select_wide_kernel(const PackedArgs a,
                                                                      const Wide w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned long long best = row_groups<int, 64>(
      a.P, a.n, a.row_bytes, w, smem, a.dirs, 2 * (long long)a.S,
      [](const RawDirs<64>& r) {
        // byte j: columns 2j, 2j + 1, values 4j .. 4j + 3 = [lo0, lo1, hi0, hi1]
        unsigned int b[4][4] = {};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            b[k][j / 4] |= ((unsigned int)quantize_int8(r.v[4 * j + k]) & 0xFFu) << (8 * (j % 4));
        }
        const auto row = [&](int k) {
          return make_int4((int)b[k][0], (int)b[k][1], (int)b[k][2], (int)b[k][3]);
        };
        return Dirs4{row(0), row(1), row(2), row(3)};
      },
      [](unsigned char* dq, int chunks, int c, const Dirs4& d) {
        int4* d4 = reinterpret_cast<int4*>(dq);
        d4[c] = d.l0;
        d4[chunks + c] = d.l1;
        d4[2 * chunks + c] = d.h0;
        d4[3 * chunks + c] = d.h1;
      },
      [](const unsigned char* dq, int chunks, int c) {
        return dirs_chunk(reinterpret_cast<const int4*>(dq), chunks, c);
      },
      [](int4 x, const Dirs4& d, int& a0, int& a1) { packed_chunk_dot(x, d, a0, a1); },
      [&](long long row) { return make_float2(a.nrminv[row], a.bias[row]); },
      [](int a0, int a1, float2 s, long long row) { return row_key(a0, a1, s.x, s.y, row); });
  finish(best, a.ws, a.idx, a.score);
}

const void* pick(int log_g) {
  switch (log_g) {
    case 0: return reinterpret_cast<const void*>(&packed_select_kernel<0>);
    case 1: return reinterpret_cast<const void*>(&packed_select_kernel<1>);
    case 2: return reinterpret_cast<const void*>(&packed_select_kernel<2>);
    case 3: return reinterpret_cast<const void*>(&packed_select_kernel<3>);
    case 4: return reinterpret_cast<const void*>(&packed_select_kernel<4>);
    default: return reinterpret_cast<const void*>(&packed_select_kernel<5>);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  P: (n, row_bytes) packed int8
// rows, 16-byte aligned, row_bytes % 16 == 0 (zero bytes past S/2 add
// nothing); dirs: (S, 2) f32 with S / 2 <= row_bytes; nrminv, bias: (n,) f32;
// workspace: 16 zero bytes owned by the caller for this stream (left zero
// again by every launch); idx/score: one int32 / one f32.  One kernel launch
// on `stream`: the ring kernel where plan_launch can place the rows (the four
// direction rows and two one-row stages in shared memory: rows up to 32 KB),
// else the wide-row kernel, up to rows of 1 MiB; never synchronizes; returns
// cudaGetLastError().
extern "C" int packed_select_launch(const void* P, long long n, long long row_bytes,
                                    const void* dirs, int S, const void* nrminv,
                                    const void* bias, void* workspace, void* idx, void* score,
                                    void* stream) {
  if (row_bytes > (1 << 20) || S > 2 * row_bytes) return (int)cudaErrorInvalidValue;
  const int rb = (int)row_bytes;
  const int log_g = group_log2(rb / 16);
  const void* kernel = pick(log_g);
  Plan plan;
  cudaError_t err =
      plan_launch(kernel, n, rb, 4 * rb, (32 >> log_g) * kRowsPerStep, kRingMaxRow, &plan);
  if (err != cudaSuccess) return (int)err;
  PackedArgs a{reinterpret_cast<const unsigned char*>(P), n, rb, plan.tile_rows, plan.stages,
               reinterpret_cast<const float*>(dirs), S, reinterpret_cast<const float*>(nrminv),
               reinterpret_cast<const float*>(bias), reinterpret_cast<Workspace*>(workspace),
               reinterpret_cast<int*>(idx), reinterpret_cast<float*>(score)};
  if (plan.stages == 0) {                             // too wide for the ring
    kernel = reinterpret_cast<const void*>(&packed_select_wide_kernel);
    WidePlan wp;
    if ((err = plan_wide(kernel, n, rb, 4, &wp)) != cudaSuccess) return (int)err;
    void* args[] = {&a, &wp.w};
    err = cudaLaunchKernel(kernel, dim3(wp.grid), dim3(kThreads), args, wp.smem,
                           reinterpret_cast<cudaStream_t>(stream));
  } else {
    void* args[] = {&a};
    err = cudaLaunchKernel(kernel, dim3(plan.grid), dim3(kThreads), args, plan.smem,
                           reinterpret_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
