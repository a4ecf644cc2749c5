// GIGA select for Hopper (sm_90a): fused scores + global first-max argmax,
// one launch per select.
//
// Replaces bayesian_coresets_tpu/ops/pallas_kernels.py::giga_select_pallas
// (the Pallas TPU kernel _giga_select_kernel).  It computes the same thing,
// with the JAX package's default-select rounding (ops/snnls.py:479-487):
//
//   q = the directions [cdir_n, xw_n] in Vsel's type, zero-padded to Sp:
//        int8: clamp(round_half_even(127 d), -127, 127);  bf16: rn;  f32: d
//   per row r of the (n, Sp) selection copy Vsel:
//     (d0, d1) = Vsel[r] . q
//        int8:     int32 dots times f32(1/127^2) (rows are pre-normalized)
//        bf16/f32: f32 accumulation, then divided by norms[r]
//     geo_ok = d1 > -1 + 1e-14  &&  1 - d1^2 > 0
//     score  = geo_ok ? d0 / sqrt(max(1 - d1^2, 1e-30)) : 0;  -inf if !valid[r]
//   result: the lowest index of the maximal score, and that score
//   (all rows invalid -> index 0, score -inf, as jnp.argmax gives).
//
// What bounds it on the H100: bytes.  Each GIGA iteration streams the whole
// selection copy once (N=100k, S=500: 51 MB of int8; N=1M: 512 MB) for 4
// integer multiply-adds per byte, far below the card's compute rate.  The
// first design (one warp per row, a grid-stride loop, a second kernel to
// decode) reached 45-56% of the HBM rate: each warp had one 512-byte row in
// flight and a serial shuffle-and-epilogue chain per row, the grid assumed
// an occupancy its registers did not allow, and every select cost a
// separate decode kernel and about six more launches in the wrapper.  This
// design (stream_rows.cuh) does:
//   - a persistent grid at the kernel's real occupancy (3 blocks of 288
//     threads per SM), each block owning a contiguous range of 8 KB tiles
//     of whole rows;
//   - a 4-stage TMA ring per block: one producer lane keeps up to 32 KB per
//     block (96 KB per SM) in flight with 1-D bulk copies, independent of
//     registers, while 8 consumer warps compute on the tiles that have
//     landed;
//   - the directions quantized in the kernel, once per block, into shared
//     memory while the first tiles arrive; each lane keeps its first chunk of both in registers for the
//     whole kernel (every chunk of an S <= 512 int8 row), and reads further
//     chunks of wider rows from shared memory;
//   - a lane group of G = pow2 >= chunks lanes per row, 4 rows per group per
//     step, and one transposed butterfly for all of them (group_reduce), so
//     the score epilogue runs once per 4 rows on every lane in parallel; the
//     per-row norms and valid bytes are loaded one step ahead, so no global
//     load waits in the epilogue;
//   - int8 dots on the CUDA cores with __dp4a; the (n, 2) dots and (n,)
//     scores never reach device memory;
//   - one launch: a packed 64-bit atomicMax per block, then the block with
//     the last ticket decodes the key and resets the workspace.
// Rows past 4 KB (f32 S > 1024, bf16 > 2048; int8 past kRingMaxRowInt8)
// take giga_select_wide_kernel below, in the same one launch.  It replaces
// the same TPU kernel (_giga_select_kernel) at wide projections, and is
// bound by bytes too (f32 n=4096, S=12289: 201 MB at two multiply-adds per 4 bytes).
// Past 4 KB a ring tile of whole rows (8 KB) holds one row, with one lane
// group of one warp working on it and only 2-4 tiles in flight, so most
// consumer warps wait: 24-57% of the bound from 16 KB to 48 KB rows, slower
// than torch.matmul at 48 KB; and a kernel that read such rows straight
// from global memory kept too few bytes in flight (one block per 36 rows,
// 18-56%).  The wide kernel instead streams groups of 8 rows in 4 KB pieces
// (stream_rows.cuh's row_groups): every consumer lane takes one 16-byte
// chunk of each piece for all 8 rows, and a 3-4 stage TMA ring keeps
// 96-128 KB in flight on each SM.  Each lane quantizes its own chunks of
// the directions, one piece ahead of use, in the block's first group and
// keeps them in shared memory for the others.  Staging the whole array
// first, block-wide, held the stream back (393 KB of f32 per block for
// int8 rows of 49168 bytes: 59% of the bound, packed 43%; PERF.md).  The 8
// rows' sums are combined in warp order, so f32 and bf16 scores are the
// same bits on every launch.
// A build whose columns are split over ranks (the proj axis of
// parallel/coreset.py) cannot score a row from its own columns: the dots
// are sums over every rank's columns.  For it the same source has a
// dots-only mode of both kernels (a template flag on the epilogue,
// giga_dots_launch: each row's raw int32 or f32 sums to an (n, 2) output,
// no score, no argmax) and a small kernel that scores the dots once they
// are summed over the ranks and takes the first maximum through the same
// row_key and finish (giga_score_launch).  Together they split the Pallas
// kernel at the point where the JAX package's sharded select psums its
// partial dots (ops/snnls.py:458-488 there); on an unsplit matrix they give
// giga_select_launch's result bit for bit.
// The TPU kernel's sequential running accumulator has no counterpart:
// blocks on Hopper run in parallel and in no order.  The score epilogue
// uses the _rn intrinsics so that FMA contraction cannot change its rounding
// against the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "stream_rows.cuh"

namespace {

// f32 rounding of 1/127^2, as the JAX package's weakly typed constant
constexpr float kInv127Sq = (float)(1.0 / (127.0 * 127.0));

enum SelectDtype { kInt8 = 0, kBf16 = 1, kF32 = 2 };

// Rows past these take the wide-row kernel: the crossover of the two
// kernels on the H100 (scripts/sweep_wide_select.py --mid).  f32 and bf16
// rows of 4112 bytes already run faster in 4 KB pieces (3% and 15%); int8
// rows stay on the ring kernel up to 4608 bytes (2-4% faster there than
// in pieces, 5% slower at 4864).  A sweep may build one other limit for
// every dtype (BCT_GIGA_RING_MAX_ROW; ring48 builds the earlier 48 KB).
#ifdef BCT_GIGA_RING_MAX_ROW
constexpr int kRingMaxRow = BCT_GIGA_RING_MAX_ROW;
constexpr int kRingMaxRowInt8 = BCT_GIGA_RING_MAX_ROW;
#else
constexpr int kRingMaxRow = 4096;
constexpr int kRingMaxRowInt8 = 4608;
#endif

struct SelectArgs {
  const unsigned char* V;
  long long n;
  int row_bytes;
  int tile_rows;
  int stages;
  const float* dirs;        // (S, 2) f32, row-major
  int S;
  const float* norms;
  const unsigned char* valid;
  Workspace* ws;
  int* idx;
  float* score;
  void* dots;               // (n, 2) raw dots of the dots-only mode, else unused
};

// Dots of one 16-byte chunk of a row against the same chunk of both
// directions, accumulated into (a0, a1).
__device__ __forceinline__ void chunk_dot(int4 v, int4 p, int4 q, int& a0, int& a1) {
  a0 = __dp4a(v.x, p.x, a0); a0 = __dp4a(v.y, p.y, a0);
  a0 = __dp4a(v.z, p.z, a0); a0 = __dp4a(v.w, p.w, a0);
  a1 = __dp4a(v.x, q.x, a1); a1 = __dp4a(v.y, q.y, a1);
  a1 = __dp4a(v.z, q.z, a1); a1 = __dp4a(v.w, q.w, a1);
}

__device__ __forceinline__ void chunk_dot(int4 v, int4 p, int4 q, float& a0, float& a1,
                                          std::integral_constant<int, kBf16>) {
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

__device__ __forceinline__ void chunk_dot(int4 v, int4 p, int4 q, float& a0, float& a1,
                                          std::integral_constant<int, kF32>) {
  const float4 x = *reinterpret_cast<const float4*>(&v);
  const float4 y = *reinterpret_cast<const float4*>(&p);
  const float4 z = *reinterpret_cast<const float4*>(&q);
  a0 = fmaf(x.x, y.x, a0); a0 = fmaf(x.y, y.y, a0);
  a0 = fmaf(x.z, y.z, a0); a0 = fmaf(x.w, y.w, a0);
  a1 = fmaf(x.x, z.x, a1); a1 = fmaf(x.y, z.y, a1);
  a1 = fmaf(x.z, z.z, a1); a1 = fmaf(x.w, z.w, a1);
}

template <int DT>
__device__ __forceinline__ void dot(int4 v, int4 p, int4 q, int& a0, int& a1) {
  chunk_dot(v, p, q, a0, a1);
}

template <int DT>
__device__ __forceinline__ void dot(int4 v, int4 p, int4 q, float& a0, float& a1) {
  chunk_dot(v, p, q, a0, a1, std::integral_constant<int, DT>());
}

// One direction value in Vsel's type: int8 is round half to even of 127 d,
// clipped to +-127; bf16 rounds to nearest even.
__device__ __forceinline__ int quantize_int8(float f) {
  const int q = __float2int_rn(__fmul_rn(f, 127.0f));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

// A row's packed key from its two summed dots, its norm (unused for int8)
// and its valid byte.
template <int DT, typename Acc>
__device__ __forceinline__ unsigned long long row_key(Acc a0, Acc a1, float nr, bool ok,
                                                      long long row) {
  float d0, d1;
  if constexpr (DT == kInt8) {
    // int32 -> f32 rounds to nearest even, as astype(float32) does (exact
    // while |dot| < 2^24, which unit rows and unit directions never pass)
    d0 = __fmul_rn((float)a0, kInv127Sq);
    d1 = __fmul_rn((float)a1, kInv127Sq);
  } else {
    d0 = __fdiv_rn(a0, nr);
    d1 = __fdiv_rn(a1, nr);
  }
  const float om = __fsub_rn(1.0f, __fmul_rn(d1, d1));
  // f32(-1 + 1e-14) == -1.0f
  const bool geo_ok = (d1 > -1.0f) && (om > 0.0f);
  float sc = geo_ok ? __fdiv_rn(d0, __fsqrt_rn(fmaxf(om, 1e-30f))) : 0.0f;
  if (!ok) sc = __int_as_float(0xff800000);         // -inf
  if (sc == 0.0f) sc = 0.0f;                        // -0 ties +0, as in argmax
  return pack_key(sc, row);
}

// The directions in Vsel's type, (2, Sp) zero-padded, into shared memory,
// by the consumer warps: every thread loads its values before it stores any.
template <int DT>
__device__ __forceinline__ void quantize_dirs(const float* __restrict__ dirs, int S, int Sp,
                                              unsigned char* dq) {
  constexpr int kStride = kConsumerWarps * 32;
  for (int base = threadIdx.x; base < 2 * Sp; base += 4 * kStride) {
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kStride;
      const int d = i >= Sp;
      const int s = i - d * Sp;
      f[k] = (i < 2 * Sp && s < S) ? dirs[2 * s + d] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kStride;
      if (i >= 2 * Sp) break;
      if constexpr (DT == kInt8) {
        reinterpret_cast<signed char*>(dq)[i] = (signed char)quantize_int8(f[k]);
      } else if constexpr (DT == kBf16) {
        reinterpret_cast<__nv_bfloat16*>(dq)[i] = __float2bfloat16_rn(f[k]);
      } else {
        reinterpret_cast<float*>(dq)[i] = f[k];
      }
    }
  }
}

// The dots-only mode's epilogue: row `row`'s two raw sums, int32 for int8
// (exact, so a sum over column blocks is exact too), else f32 (not yet
// divided by the norm), as one 8-byte store into the (n, 2) output.
__device__ __forceinline__ void store_dots(void* out, long long row, int a0, int a1) {
  reinterpret_cast<int2*>(out)[row] = make_int2(a0, a1);
}

__device__ __forceinline__ void store_dots(void* out, long long row, float a0, float a1) {
  reinterpret_cast<float2*>(out)[row] = make_float2(a0, a1);
}

// DOTS: the dots-only mode (giga_dots_launch): the same stream, directions
// and sums, but each row's raw (d0, d1) is written to a.dots, and there is
// no score, no argmax and no workspace.
template <int DT, int LOG_G, bool DOTS>
__global__ void __launch_bounds__(kThreads) giga_select_kernel(const SelectArgs a) {
  using Acc = typename std::conditional<DT == kInt8, int, float>::type;
  constexpr int U = kRowsPerStep;
  constexpr int G = 1 << LOG_G;
  constexpr int RPW = 32 >> LOG_G;                    // row groups per warp
  constexpr int SR = RPW * U;                         // rows per warp step
  using R = Reduced<LOG_G, U>;
  constexpr int elem = DT == kInt8 ? 1 : (DT == kBf16 ? 2 : 4);

  extern __shared__ __align__(128) unsigned char smem[];
  const int rb = a.row_bytes;
  const int C = rb / 16;                              // chunks per row
  unsigned char* dq = smem + kBarBytes;               // (2, Sp) directions
  const Ring ring = ring_setup(smem, dq + 2 * rb, a.stages, a.tile_rows * rb);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (G - 1);                     // lane within its group
  const int grp = lane >> LOG_G;                      // group within the warp
  const int4* d4 = reinterpret_cast<const int4*>(dq);
  int4 p0 = make_int4(0, 0, 0, 0), q0 = p0;
  if (warp < kConsumerWarps) {                        // meanwhile the producer streams
    quantize_dirs<DT>(a.dirs, a.S, rb / elem, dq);
    consumer_sync();
    if (sub < C) {
      p0 = d4[sub];
      q0 = d4[C + sub];
    }
  }
  const int u0 = value_offset<LOG_G, U>(lane) >> 1;   // this lane's first row of a step
  const int spt = (a.tile_rows + SR - 1) / SR;        // steps per tile
  // Warp w takes the block's steps q = w, w + 8, ... (step q is step q % spt
  // of tile q / spt).  The valid bytes and norms of this lane's epilogue
  // rows are loaded one step ahead, so no global load waits in the epilogue.
  const Span span = block_span(a.n, a.tile_rows);
  bool ok_next[R::E] = {};
  float nr_next[R::E] = {};
  const auto prefetch = [&](long long q) {
    if constexpr (DOTS) return;                       // no per-row inputs
    const long long t = q / spt;
    const long long row0 = (span.first + t) * a.tile_rows;
#pragma unroll
    for (int e = 0; e < R::E; ++e) {
      const int rl = (int)(q - t * spt) * SR + (u0 + e) * RPW + grp;
      ok_next[e] = false;
      nr_next[e] = 1.0f;
      if (t < span.count && rl < a.tile_rows && row0 + rl < a.n) {
        ok_next[e] = a.valid[row0 + rl] != 0;
        if constexpr (DT != kInt8) nr_next[e] = a.norms[row0 + rl];
      }
    }
  };
  if (warp < kConsumerWarps) prefetch(warp);
  unsigned long long best = 0ull;                     // below every real key

  stream_rows(a.V, a.n, rb, a.tile_rows, ring,
              [&](const unsigned char* buf, long long i, long long row0, int rows) {
    for (int s = (warp - (int)((i * spt) & 7)) & 7; s < spt; s += kConsumerWarps) {
      const int r0 = s * SR;
      if (r0 >= rows) break;
      bool ok[R::E];
      float nr[R::E];
#pragma unroll
      for (int e = 0; e < R::E; ++e) {
        ok[e] = ok_next[e];
        nr[e] = nr_next[e];
      }
      prefetch(i * spt + s + kConsumerWarps);
      Acc v[2 * U];
#pragma unroll
      for (int k = 0; k < 2 * U; ++k) v[k] = 0;
      for (int c = sub; c < C; c += G) {
        const int4 p = c == sub ? p0 : d4[c];
        const int4 q = c == sub ? q0 : d4[C + c];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int rl = r0 + u * RPW + grp;
          if (rl < rows) {
            const int4 x = reinterpret_cast<const int4*>(buf + (size_t)rl * rb)[c];
            dot<DT>(x, p, q, v[2 * u], v[2 * u + 1]);
          }
        }
      }
      group_reduce<LOG_G, U>(v, lane);
#pragma unroll
      for (int e = 0; e < R::E; ++e) {
        Acc a0, a1;
        row_pair<LOG_G, U>(v, lane, e, a0, a1);
        const int rl = r0 + (u0 + e) * RPW + grp;
        if (rl < rows) {
          if constexpr (DOTS) {
            store_dots(a.dots, row0 + rl, a0, a1);
          } else {
            const unsigned long long key = row_key<DT>(a0, a1, nr[e], ok[e], row0 + rl);
            best = key > best ? key : best;
          }
        }
      }
    }
  });
  if constexpr (!DOTS) finish(best, a.ws, a.idx, a.score);
}

// One 16-byte chunk's columns of both directions, in Vsel's type; for bf16
// the wide-row kernel keeps them widened to f32 (exactly), so a piece's
// directions are widened once for all the rows of a group, not once a row.
template <int DT>
struct Dirs2 {
  int4 p, q;
};

template <>
struct Dirs2<kBf16> {
  float p[8], q[8];
};

// The same select for rows past the ring's limit (stream_rows.cuh's
// row_groups): groups of 8 rows in 4 KB pieces through a 3-4 stage TMA
// ring, one block per SM.  Each lane quantizes its own chunks of the
// directions from the f32 array in the block's first group, as
// quantize_dirs does, bit for bit, and keeps them in shared memory for the
// later groups (rows up to 65984 bytes on the H100; wider rows fetch them
// again in every group); bf16 directions are widened once a piece (Dirs2).
// The row sums are combined in warp order, so f32 and bf16 scores are the same bits on every launch.  DOTS: the dots-only
// mode, as in giga_select_kernel.
template <int DT, bool DOTS>
__global__ void __launch_bounds__(kThreads) giga_select_wide_kernel(const SelectArgs a,
                                                                    const Wide w) {
  using Acc = typename std::conditional<DT == kInt8, int, float>::type;
  constexpr int E = DT == kInt8 ? 16 : (DT == kBf16 ? 8 : 4);   // columns per chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned long long best = row_groups<Acc, 2 * E>(
      a.V, a.n, a.row_bytes, w, smem, a.dirs, 2 * (long long)a.S,
      [](const RawDirs<2 * E>& r) {
        Dirs2<DT> d;
        if constexpr (DT == kBf16) {
#pragma unroll
          for (int k = 0; k < E; ++k) {
            d.p[k] = __bfloat162float(__float2bfloat16_rn(r.v[2 * k]));
            d.q[k] = __bfloat162float(__float2bfloat16_rn(r.v[2 * k + 1]));
          }
        } else {
          unsigned int p[4] = {}, q[4] = {};
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const float f0 = r.v[2 * k], f1 = r.v[2 * k + 1];
            if constexpr (DT == kInt8) {
              p[k / 4] |= ((unsigned int)quantize_int8(f0) & 0xFFu) << (8 * (k % 4));
              q[k / 4] |= ((unsigned int)quantize_int8(f1) & 0xFFu) << (8 * (k % 4));
            } else {
              p[k] = __float_as_uint(f0);
              q[k] = __float_as_uint(f1);
            }
          }
          d.p = make_int4((int)p[0], (int)p[1], (int)p[2], (int)p[3]);
          d.q = make_int4((int)q[0], (int)q[1], (int)q[2], (int)q[3]);
        }
        return d;
      },
      [](unsigned char* dq, int chunks, int c, const Dirs2<DT>& d) {
        int4* d4 = reinterpret_cast<int4*>(dq);
        if constexpr (DT == kBf16) {           // back to bf16 bits (exact)
          unsigned int p[4], q[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            p[k] = (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(d.p[2 * k])) |
                   (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(d.p[2 * k + 1])) << 16;
            q[k] = (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(d.q[2 * k])) |
                   (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(d.q[2 * k + 1])) << 16;
          }
          d4[c] = make_int4((int)p[0], (int)p[1], (int)p[2], (int)p[3]);
          d4[chunks + c] = make_int4((int)q[0], (int)q[1], (int)q[2], (int)q[3]);
        } else {
          d4[c] = d.p;
          d4[chunks + c] = d.q;
        }
      },
      [](const unsigned char* dq, int chunks, int c) {
        const int4* d4 = reinterpret_cast<const int4*>(dq);
        Dirs2<DT> d;
        if constexpr (DT == kBf16) {
          const int4 p = d4[c], q = d4[chunks + c];
          const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&p);
          const __nv_bfloat162* qq = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 y = __bfloat1622float2(pp[k]), z = __bfloat1622float2(qq[k]);
            d.p[2 * k] = y.x; d.p[2 * k + 1] = y.y;
            d.q[2 * k] = z.x; d.q[2 * k + 1] = z.y;
          }
        } else {
          d.p = d4[c];
          d.q = d4[chunks + c];
        }
        return d;
      },
      [](int4 x, const Dirs2<DT>& d, Acc& a0, Acc& a1) {
        if constexpr (DT == kBf16) {           // chunk_dot's order, directions widened
          const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 v = __bfloat1622float2(vv[i]);
            a0 = fmaf(v.x, d.p[2 * i], a0); a0 = fmaf(v.y, d.p[2 * i + 1], a0);
            a1 = fmaf(v.x, d.q[2 * i], a1); a1 = fmaf(v.y, d.q[2 * i + 1], a1);
          }
        } else {
          dot<DT>(x, d.p, d.q, a0, a1);
        }
      },
      [&](long long row) {
        if constexpr (DOTS) return make_float2(1.0f, 1.0f);   // no per-row inputs
        return make_float2(DT == kInt8 ? 1.0f : a.norms[row], a.valid[row] ? 1.0f : 0.0f);
      },
      [&](Acc a0, Acc a1, float2 s, long long row) -> unsigned long long {
        if constexpr (DOTS) {
          store_dots(a.dots, row, a0, a1);
          return 0ull;
        } else {
          return row_key<DT>(a0, a1, s.x, s.y != 0.0f, row);
        }
      });
  if constexpr (!DOTS) finish(best, a.ws, a.idx, a.score);
}

template <bool DOTS>
const void* wide_kernel(int dtype) {
  return dtype == kInt8   ? reinterpret_cast<const void*>(&giga_select_wide_kernel<kInt8, DOTS>)
         : dtype == kBf16 ? reinterpret_cast<const void*>(&giga_select_wide_kernel<kBf16, DOTS>)
                          : reinterpret_cast<const void*>(&giga_select_wide_kernel<kF32, DOTS>);
}

template <int DT, bool DOTS>
const void* pick(int log_g) {
  switch (log_g) {
    case 0: return reinterpret_cast<const void*>(&giga_select_kernel<DT, 0, DOTS>);
    case 1: return reinterpret_cast<const void*>(&giga_select_kernel<DT, 1, DOTS>);
    case 2: return reinterpret_cast<const void*>(&giga_select_kernel<DT, 2, DOTS>);
    case 3: return reinterpret_cast<const void*>(&giga_select_kernel<DT, 3, DOTS>);
    case 4: return reinterpret_cast<const void*>(&giga_select_kernel<DT, 4, DOTS>);
    default: return reinterpret_cast<const void*>(&giga_select_kernel<DT, 5, DOTS>);
  }
}

// One launch of the select (DOTS false) or of its dots-only mode on
// `stream`: the ring kernel where plan_launch can place the rows, else the
// wide-row kernel; never synchronizes; returns cudaGetLastError().
template <bool DOTS>
int launch_select(SelectArgs a, int dtype, void* stream) {
  if (dtype < kInt8 || dtype > kF32 || a.row_bytes <= 0 || a.row_bytes > (1 << 20))
    return (int)cudaErrorInvalidValue;
  const int rb = a.row_bytes;
  const int log_g = group_log2(rb / 16);
  const void* kernel = dtype == kInt8 ? pick<kInt8, DOTS>(log_g)
                       : dtype == kBf16 ? pick<kBf16, DOTS>(log_g)
                                        : pick<kF32, DOTS>(log_g);
  Plan plan;
  cudaError_t err = plan_launch(kernel, a.n, rb, 2 * rb, (32 >> log_g) * kRowsPerStep,
                                dtype == kInt8 ? kRingMaxRowInt8 : kRingMaxRow, &plan);
  if (err != cudaSuccess) return (int)err;
  a.tile_rows = plan.tile_rows;
  a.stages = plan.stages;
  if (plan.stages == 0) {                             // too wide for the ring
    kernel = wide_kernel<DOTS>(dtype);
    WidePlan wp;
    if ((err = plan_wide(kernel, a.n, rb, 2, &wp)) != cudaSuccess) return (int)err;
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

// The score and first-max argmax of dots summed elsewhere (giga_score_launch):
// rows of the (n, 2) dots, int32 (DT kInt8: scaled by 1/127^2) or f32
// (divided by the row's norm), through row_key and finish, as the fused
// select scores its own sums.  A grid-stride loop, one thread a row.  At
// 12-13 bytes a row (0.9 MB at n=100k) the byte bound is a fraction of a
// microsecond; what sets the time is a chain of latencies (the launch, a
// load, a row's two divisions and square root, the block's reduction, the
// finish's atomics and the last block's read of the key), and on the H100
// it takes 2.5-3 us more than an empty kernel launched the same way.
// Measured and not kept (scripts/sweep_wide_select.py --score; PERF.md):
// one block per SM of 256-1024 threads, 2-16 rows a thread with 16-byte
// loads, clusters whose rank 0 alone does the atomics, and per-block keys
// in slots reduced by the block of the last ticket.
template <int DT>
__global__ void __launch_bounds__(kThreads) giga_score_kernel(
    const void* __restrict__ dots, long long n, const float* __restrict__ norms,
    const unsigned char* __restrict__ valid, Workspace* __restrict__ ws, int* __restrict__ idx,
    float* __restrict__ score) {
  using Pair = typename std::conditional<DT == kInt8, int2, float2>::type;
  unsigned long long best = 0ull;                     // below every real key
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < n;
       r += (long long)gridDim.x * kThreads) {
    const Pair d = reinterpret_cast<const Pair*>(dots)[r];
    const float nr = DT == kInt8 ? 1.0f : norms[r];
    const unsigned long long key = row_key<DT>(d.x, d.y, nr, valid[r] != 0, r);
    best = key > best ? key : best;
  }
  finish(best, ws, idx, score);
}

// The floor of a launch-bound kernel: nothing, launched by the same host
// path as the score kernel (giga_empty_launch; measurement only).
__global__ void empty_kernel() {}

// The score kernel's grid: a block per kThreads rows, at most 4 per SM.
inline cudaError_t score_grid(long long n, int* grid) {
  int dev = 0, sms = 0;
  size_t budget = 0;
  const cudaError_t err = device_limits(&dev, &sms, &budget);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  *grid = (int)(blocks < 4ll * sms ? blocks : 4ll * sms);
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (bound with ctypes).  V: (n, row_bytes / elem) rows,
// 16-byte aligned, row_bytes % 16 == 0; dirs: (S, 2) f32, S <= row_bytes /
// elem; norms: (n,) f32 (unused for int8); valid: (n,) bool; workspace: 16
// zero bytes owned by the caller for this stream (left zero again by every
// launch); idx/score: one int32 / one f32.  One kernel launch on `stream`:
// the ring kernel for rows of at most 4 KB (int8: 4608 bytes), else the
// wide-row kernel, up to rows of 1 MiB; never synchronizes; returns
// cudaGetLastError().
extern "C" int giga_select_launch(const void* V, int dtype, long long n, long long row_bytes,
                                  const void* dirs, int S, const void* norms, const void* valid,
                                  void* workspace, void* idx, void* score, void* stream) {
  if (row_bytes > (1 << 20)) return (int)cudaErrorInvalidValue;
  SelectArgs a{reinterpret_cast<const unsigned char*>(V), n, (int)row_bytes, 0, 0,
               reinterpret_cast<const float*>(dirs), S, reinterpret_cast<const float*>(norms),
               reinterpret_cast<const unsigned char*>(valid),
               reinterpret_cast<Workspace*>(workspace), reinterpret_cast<int*>(idx),
               reinterpret_cast<float*>(score), nullptr};
  return launch_select<false>(a, dtype, stream);
}

// The dots-only mode, for a select whose columns are split over ranks (the
// proj axis of a sharded build): V, dtype, n, row_bytes, dirs and S as for
// giga_select_launch (the directions quantized in the kernel, bit for bit
// as there); out: (n, 2) row-major, int32 for int8 (the raw integer sums)
// and f32 for bf16/f32 (the sums, not divided by the norm).  One launch of
// the same stream (ring or wide-row kernel) on `stream`; no workspace;
// never synchronizes; returns cudaGetLastError().
extern "C" int giga_dots_launch(const void* V, int dtype, long long n, long long row_bytes,
                                const void* dirs, int S, void* out, void* stream) {
  if (row_bytes > (1 << 20)) return (int)cudaErrorInvalidValue;
  SelectArgs a{reinterpret_cast<const unsigned char*>(V), n, (int)row_bytes, 0, 0,
               reinterpret_cast<const float*>(dirs), S, nullptr, nullptr, nullptr, nullptr,
               nullptr, out};
  return launch_select<true>(a, dtype, stream);
}

// The score and global first-max argmax of (n, 2) dots summed over the
// split (giga_dots_launch's output reduced over the ranks): dots_int32 1
// for int32 dots (an int8 select: scaled by 1/127^2), 0 for f32 dots
// (divided by norms[r]); norms (n,) f32, valid (n,) bool, workspace, idx
// and score as for giga_select_launch, whose result it gives on the
// unsplit matrix bit for bit.  One launch on `stream`; never synchronizes;
// returns cudaGetLastError().
extern "C" int giga_score_launch(const void* dots, int dots_int32, long long n, const void* norms,
                                 const void* valid, void* workspace, void* idx, void* score,
                                 void* stream) {
  if (n <= 0 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = score_grid(n, &grid);
  if (err != cudaSuccess) return (int)err;
  const void* kernel = dots_int32 ? reinterpret_cast<const void*>(&giga_score_kernel<kInt8>)
                                  : reinterpret_cast<const void*>(&giga_score_kernel<kF32>);
  const long long nn = n;
  void* args[] = {const_cast<void**>(&dots), const_cast<long long*>(&nn),
                  const_cast<void**>(&norms), const_cast<void**>(&valid), &workspace, &idx,
                  &score};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, 0,
                         reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The practical floor of giga_score_launch's time: the same arguments and
// the same host work (the grid from the device's SM count, one launch, the
// error check), but an empty kernel of one block; it touches nothing.  For
// measurement only (chip_smoke.py times it beside the score kernel).
extern "C" int giga_empty_launch(const void* dots, int dots_int32, long long n, const void* norms,
                                 const void* valid, void* workspace, void* idx, void* score,
                                 void* stream) {
  (void)dots; (void)dots_int32; (void)norms; (void)valid; (void)workspace; (void)idx;
  (void)score;
  if (n <= 0 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = score_grid(n, &grid);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(reinterpret_cast<const void*>(&empty_kernel), dim3(1), dim3(32), nullptr,
                         0, reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
