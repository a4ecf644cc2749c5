// A persistent, TMA-fed stream of whole rows (stream_rows), one of groups of
// wide rows walked piece by piece (row_groups), and a one-launch argmax
// finish, shared by the select kernels (giga_select.cu, packed_select.cu).
//
// Layout of a launch:
//   - a persistent grid: SMs x the blocks of this kernel that fit on an SM
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its real register
//     and shared-memory use), capped at the number of tiles, so every block
//     is resident from the start and there is no partial second wave;
//   - each block owns a contiguous range of tiles; a tile is `tile_rows`
//     whole rows, i.e. one contiguous 16-byte-aligned byte range, so one
//     1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes) moves
//     it; the ragged last tile copies only the rows that exist;
//   - a ring of `stages` tiles in dynamic shared memory, each stage with a
//     "full" mbarrier (the copy's byte count) and an "empty" one (one
//     arrival per consumer warp); one elected lane of a ninth, producer warp
//     keeps every stage in flight, so up to stages x tile bytes per block
//     (32 KB at 4 x 8 KB; 96 KB per SM) are on their way while 8 consumer
//     warps compute on the tiles that have landed;
//   - the finish: each block folds its best key into the device maximum with
//     one atomicMax, fences, and takes a ticket; the block with the last
//     ticket decodes the key into (idx, score) and resets key and ticket to
//     0, so the workspace is ready for the next launch on the stream.
//
// Rows past the ring's limit (GIGA 4 KB, int8 4608 bytes; packed 32 KB:
// past 4 KB a tile holds one row, and one warp of eight computes on it)
// take row_groups below instead: the same persistent grid (one block per
// SM: the quantized directions of the whole row fill up to half of its
// shared memory), the same finish, but ring stages of one 4 KB piece of
// each of kGroupRows rows, so every consumer lane works on every stage,
// and 96-128 KB in flight per SM again.
//
// Everything here has internal linkage: each kernel source includes its own
// copy, so the library links without duplicate symbols.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "select_key.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;    // + one producer warp
// 4 stages of 8 KB: 32 KB in flight per block, 96 KB per SM at the 3
// blocks an SM holds.  Smaller tiles even out the blocks' last tiles at
// N=100k; a deeper ring of larger tiles would leave room for fewer blocks,
// and so fewer consumer warps, per SM.
constexpr int kMaxStages = 4;
constexpr int kTileTarget = 8192;                      // bytes per tile
constexpr int kBarBytes = 128;                         // 2 x kMaxStages mbarriers
constexpr int kRowsPerStep = 4;                        // rows per lane group per step
// The wide-row stream (row_groups): a work item is a group of kGroupRows
// whole rows, walked in pieces of kPieceBytes (one 16-byte chunk per
// consumer lane); a ring stage holds one piece of each row of the group.
// Stages: as many as fit up to kWideMaxStages, and at least enough for
// kWideInFlight bytes per block (one block per SM: the directions fill the
// rest of its shared memory).  The macros let a sweep build variants.
#ifndef BCT_WIDE_GROUP_ROWS
#define BCT_WIDE_GROUP_ROWS 8
#endif
#ifndef BCT_WIDE_MAX_STAGES
#define BCT_WIDE_MAX_STAGES 4
#endif
constexpr int kGroupRows = BCT_WIDE_GROUP_ROWS;
constexpr int kPieceBytes = kConsumerWarps * 32 * 16;  // 4096
constexpr int kWideMaxStages = BCT_WIDE_MAX_STAGES;
constexpr int kWideInFlight = 96 * 1024;
// per-warp partial sums of a group, double-buffered: [2][kConsumerWarps][2R]
constexpr int kPartBytes = 2 * kConsumerWarps * 2 * kGroupRows * 4;
static_assert(kWideMaxStages <= kMaxStages, "the ring has kMaxStages barrier pairs");
static_assert(kGroupRows <= 32, "one lane of warp 0 scores each row of a group");

// The per-(device, stream) state of the one-launch finish; zero between
// launches.
struct Workspace {
  unsigned long long key;
  unsigned int ticket;
  unsigned int pad;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy global -> shared; completion is reported to `bar` as bytes.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned int bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* buf;
  int stages;
  int tile_bytes;
};

// Thread 0 initializes the barriers; the caller syncs the block before use.
__device__ __forceinline__ Ring ring_setup(unsigned char* smem, unsigned char* buf, int stages,
                                           int tile_bytes) {
  Ring r{reinterpret_cast<uint64_t*>(smem), reinterpret_cast<uint64_t*>(smem) + kMaxStages, buf,
         stages, tile_bytes};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return r;
}

// Syncs the consumer warps only (named barrier 1), so the producer warp
// can start the stream while they prepare.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// This block's contiguous range of tiles: [first, first + count).
struct Span {
  long long first;
  long long count;
};

__device__ __forceinline__ Span block_span(long long n, int tile_rows) {
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const long long first = tiles * blockIdx.x / gridDim.x;
  return Span{first, tiles * (blockIdx.x + 1) / gridDim.x - first};
}

// Streams this block's tiles of the (n, row_bytes) rows at `src` through the
// ring.  Consumer warps call consume(buf, i, row0, rows) for the block's
// i-th tile (rows [row0, row0 + rows) at `buf` in shared memory); the
// producer warp's lane 0 issues the copies.  Every thread returns.
template <class F>
__device__ __forceinline__ void stream_rows(const unsigned char* __restrict__ src, long long n,
                                            int row_bytes, int tile_rows, const Ring& ring,
                                            F&& consume) {
  const Span span = block_span(n, tile_rows);
  const long long first = span.first, count = span.count;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kConsumerWarps) {
    if (lane == 0) {
      for (long long i = 0; i < count; ++i) {
        const int st = (int)(i % ring.stages);
        if (i >= ring.stages) mbar_wait(ring.empty + st, (unsigned int)((i / ring.stages - 1) & 1));
        const long long row0 = (first + i) * tile_rows;
        const long long left = n - row0;
        const unsigned int bytes = (unsigned int)((left < tile_rows ? left : tile_rows) * row_bytes);
        mbar_expect_tx(ring.full + st, bytes);
        bulk_g2s(ring.buf + (size_t)st * ring.tile_bytes, src + row0 * row_bytes, bytes,
                 ring.full + st);
      }
    }
    return;
  }
  for (long long i = 0; i < count; ++i) {
    const int st = (int)(i % ring.stages);
    mbar_wait(ring.full + st, (unsigned int)((i / ring.stages) & 1));
    const long long row0 = (first + i) * tile_rows;
    const long long left = n - row0;
    consume(ring.buf + (size_t)st * ring.tile_bytes, i, row0,
            (int)(left < tile_rows ? left : tile_rows));
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + st);
  }
}

// The launch shape of the wide-row stream (plan_wide).
struct Wide {
  int stages;       // ring stages, each kGroupRows pieces of kPieceBytes
  int dirs_bytes;   // the whole row's quantized directions in shared memory
                    // (0: they do not fit, every group fetches them)
};

// The f32 values of one 16-byte chunk's directions, V of them, in the f32
// (S, 2) array's order: value 2 s + d is column s, direction d.
template <int V>
struct RawDirs {
  float v[V];
};

// Values [first, first + V) of the f32 directions, zero from `valid` on:
// 16-byte loads where the array allows, else one value at a time.
template <int V>
__device__ __forceinline__ void fetch_dirs(const float* __restrict__ dirs, long long valid,
                                           long long first, RawDirs<V>& r) {
  const float* p = dirs + first;
  if (first + V <= valid && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + k);
      r.v[4 * k] = f.x;
      r.v[4 * k + 1] = f.y;
      r.v[4 * k + 2] = f.z;
      r.v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = first + k < valid ? __ldg(p + k) : 0.0f;
  }
}

// The wide-row stream.  The block owns a contiguous range of groups of
// kGroupRows whole rows, and walks each group's rows together in pieces of
// kPieceBytes, in order; ring stage i holds piece p of every row of the
// group (one bulk copy per row), which the producer warp's lane 0 keeps in
// flight as stream_rows does.  Consumer thread t takes chunk t of each
// piece for all the group's rows, so it needs one direction chunk per
// piece, which it keeps in registers for the kGroupRows rows:
//   - the directions are V f32 values per chunk of `dirs` (valid values
//     from 0 to `valid`, zero past them); in the block's first group thread
//     t fetches its own chunks' values (fetch_dirs, one piece ahead, so the
//     loads overlap the stream) and quantizes them, quant(raw) -> d; where
//     the whole row's fit (dirs_bytes) it also stores them in shared
//     memory, put(dq, chunks, c, d), and later groups read them back,
//     get(dq, chunks, c); elsewhere every group fetches them.  Each thread
//     reads only what it wrote: no barrier;
//   - dot(x, d, a0, a1) adds one chunk's products to a row's two sums, which
//     stay in registers across the group's pieces; then each warp sums them
//     by a butterfly, and warp 0 adds the eight warps' sums in warp order
//     (no atomics: the same inputs give the same bits on every launch);
//   - scalars(row) loads a row's per-row inputs when its group starts, and
//     key(a0, a1, s, row) is the row's packed key.
// Called by every thread; returns this thread's best key (0: none).
template <typename Acc, int V, class Quant, class Put, class Get, class Dot, class Scalars,
          class Key>
__device__ __forceinline__ unsigned long long row_groups(
    const unsigned char* __restrict__ src, long long n, int row_bytes, const Wide w,
    unsigned char* smem, const float* __restrict__ dirs, long long valid, Quant&& quant,
    Put&& put, Get&& get, Dot&& dot, Scalars&& scalars, Key&& key) {
  constexpr int R = kGroupRows;
  constexpr int kChunksPerPiece = kPieceBytes / 16;
  Acc* part = reinterpret_cast<Acc*>(smem + kBarBytes);
  unsigned char* dq = smem + kBarBytes + kPartBytes;
  const Ring ring = ring_setup(smem, dq + w.dirs_bytes, w.stages, R * kPieceBytes);
  __syncthreads();
  const Span span = block_span(n, R);
  const int pieces = (row_bytes + kPieceBytes - 1) / kPieceBytes;
  const int chunks = row_bytes / 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kConsumerWarps) {                       // the producer
    if (lane == 0) {
      long long i = 0;
      for (long long g = span.first; g < span.first + span.count; ++g) {
        const long long row0 = g * R;
        const int rows = (int)(n - row0 < R ? n - row0 : R);
        for (int p = 0; p < pieces; ++p, ++i) {
          const int st = (int)(i % ring.stages);
          if (i >= ring.stages)
            mbar_wait(ring.empty + st, (unsigned int)((i / ring.stages - 1) & 1));
          const int off = p * kPieceBytes;
          const unsigned int bytes = (unsigned int)min(kPieceBytes, row_bytes - off);
          unsigned char* dst = ring.buf + (size_t)st * ring.tile_bytes;
          mbar_expect_tx(ring.full + st, rows * bytes);
          for (int u = 0; u < rows; ++u)
            bulk_g2s(dst + u * kPieceBytes, src + (row0 + u) * row_bytes + off, bytes,
                     ring.full + st);
        }
      }
    }
    return 0ull;
  }

  const int t = threadIdx.x;                          // chunk t of every piece
  RawDirs<V> raw;
  unsigned long long best = 0ull;                     // below every real key
  long long i = 0;
  for (long long g = span.first; g < span.first + span.count; ++g) {
    const long long row0 = g * R;
    const int rows = (int)(n - row0 < R ? n - row0 : R);
    const bool fresh = !w.dirs_bytes || g == span.first;
    const auto sc = scalars(row0 + (warp == 0 && lane < rows ? lane : 0));
    if (fresh && t < chunks) fetch_dirs<V>(dirs, valid, (long long)t * V, raw);
    Acc v[2 * R];
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) v[k] = 0;
    for (int p = 0; p < pieces; ++p, ++i) {
      const int c = p * kChunksPerPiece + t;          // this thread's chunk of the row
      decltype(quant(raw)) d;
      if (c < chunks) {
        if (fresh) {
          d = quant(raw);
          if (w.dirs_bytes) put(dq, chunks, c, d);
          if (c + kChunksPerPiece < chunks)           // the next piece's, in flight meanwhile
            fetch_dirs<V>(dirs, valid, (long long)(c + kChunksPerPiece) * V, raw);
        } else {
          d = get(dq, chunks, c);
        }
      }
      const int st = (int)(i % ring.stages);
      mbar_wait(ring.full + st, (unsigned int)((i / ring.stages) & 1));
      if (c < chunks) {
        const unsigned char* b = ring.buf + (size_t)st * ring.tile_bytes + t * 16;
        int4 x[R];
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (u < rows) x[u] = *reinterpret_cast<const int4*>(b + u * kPieceBytes);
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (u < rows) dot(x[u], d, v[2 * u], v[2 * u + 1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty + st);
    }
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], o);
    }
    Acc* pg = part + ((g - span.first) & 1) * (kConsumerWarps * 2 * R);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 2 * R; ++k) pg[warp * 2 * R + k] = v[k];
    }
    // one barrier per group: warp 0 reads this buffer before it reaches the
    // next group's barrier, after which the other warps write the other one
    consumer_sync();
    if (warp == 0 && lane < rows) {                   // lane u scores row row0 + u
      Acc a0 = pg[2 * lane], a1 = pg[2 * lane + 1];
#pragma unroll
      for (int ww = 1; ww < kConsumerWarps; ++ww) {
        a0 += pg[ww * 2 * R + 2 * lane];
        a1 += pg[ww * 2 * R + 2 * lane + 1];
      }
      const unsigned long long k = key(a0, a1, sc, row0 + lane);
      best = k > best ? k : best;
    }
    __syncwarp();
  }
  return best;
}

// The block's best key (every thread passes its own; 0 = none) into the
// device maximum; the last block decodes it into (idx, score) and resets
// the workspace.  Called by every thread of the block.
__device__ __forceinline__ void finish(unsigned long long best, Workspace* __restrict__ ws,
                                       int* __restrict__ idx, float* __restrict__ score) {
  __shared__ unsigned long long warp_best[kConsumerWarps + 1];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    best = o > best ? o : best;
  }
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = warp_best[0];
#pragma unroll
    for (int w = 1; w <= kConsumerWarps; ++w) m = warp_best[w] > m ? warp_best[w] : m;
    if (m) atomicMax(&ws->key, m);
    __threadfence();
    if (atomicAdd(&ws->ticket, 1u) == gridDim.x - 1) {
      __threadfence();
      decode_key(atomicExch(&ws->key, 0ull), idx, score);
      atomicExch(&ws->ticket, 0u);
    }
  }
}

// Host side: the launch shape of one select.  stages == 0: the rows are too
// wide for the ring; plan_wide gives the wide-row kernel's shape.
struct Plan {
  int grid;
  int stages;
  int tile_rows;
  size_t smem;
};

// The device's SM count and the dynamic shared memory a block may use
// (the opt-in maximum less room for static shared memory).
inline cudaError_t device_limits(int* dev, int* sms, size_t* budget) {
  int optin = 0;
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev)) !=
      cudaSuccess)
    return err;
  *budget = (size_t)optin - 1024;
  return cudaSuccess;
}

// Blocks of `kernel` resident per SM at `smem` bytes of dynamic shared
// memory (cached per kernel, device and size).  The first call for a
// (kernel, device) allows the kernel the whole budget.
inline cudaError_t resident_blocks(const void* kernel, int dev, size_t budget, size_t smem,
                                   int* occ) {
  static std::mutex mu;
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int occ;
  };
  static Entry cache[64];
  static int cached = 0;
  static struct { const void* kernel; int dev; } opened[64];
  static int n_opened = 0;
  std::lock_guard<std::mutex> lock(mu);
  bool open = false;
  for (int i = 0; i < n_opened; ++i)
    open = open || (opened[i].kernel == kernel && opened[i].dev == dev);
  if (!open) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)budget);
    if (err != cudaSuccess) return err;
    if (n_opened < 64) {
      opened[n_opened].kernel = kernel;
      opened[n_opened].dev = dev;
      ++n_opened;
    }
  }
  *occ = 0;
  for (int i = 0; i < cached && !*occ; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev && cache[i].smem == smem)
      *occ = cache[i].occ;
  if (!*occ) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (*occ < 1) return cudaErrorInvalidConfiguration;
    cache[cached % 64] = Entry{kernel, dev, smem, *occ};
    if (cached < 64) ++cached;
  }
  return cudaSuccess;
}

// Rows per tile: about kTileTarget bytes, a whole number of steps of
// `step_rows` rows when a step fits; stages: kMaxStages, fewer if the
// device's shared memory cannot hold them (at least 2); grid: SMs x resident
// blocks, capped at the tile count.  `kernel` is the instantiation to run.
// Rows past `ring_max_row` bytes, or whose directions and two one-row
// stages do not fit the block's shared memory, are the wide-row kernel's
// (stages == 0).
inline cudaError_t plan_launch(const void* kernel, long long n, int row_bytes, int dirs_bytes,
                               int step_rows, int ring_max_row, Plan* out) {
  if (n <= 0 || row_bytes <= 0 || row_bytes % 16) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  size_t budget = 0;
  cudaError_t err = device_limits(&dev, &sms, &budget);
  if (err != cudaSuccess) return err;
  int tile_rows = kTileTarget / row_bytes;
  if (tile_rows < 1) tile_rows = 1;
  if (tile_rows >= step_rows) tile_rows -= tile_rows % step_rows;
  if ((long long)tile_rows > n) tile_rows = (int)n;
  const size_t tile_bytes = (size_t)tile_rows * row_bytes;
  const size_t fixed = kBarBytes + (size_t)dirs_bytes;
  int stages = kMaxStages;
  while (stages > 2 && fixed + stages * tile_bytes > budget) --stages;
  const size_t smem = fixed + stages * tile_bytes;
  if (row_bytes > ring_max_row || smem > budget) {    // rows too wide for the ring
    *out = Plan{0, 0, 0, 0};
    return cudaSuccess;
  }
  int occ = 0;
  if ((err = resident_blocks(kernel, dev, budget, smem, &occ)) != cudaSuccess) return err;
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const long long cap = (long long)sms * occ;
  out->grid = (int)(tiles < cap ? tiles : cap);
  out->stages = stages;
  out->tile_rows = tile_rows;
  out->smem = smem;
  return cudaSuccess;
}

struct WidePlan {
  int grid;
  Wide w;
  size_t smem;
};

// The wide-row kernel's shape for (n, row_bytes) rows whose quantized
// directions take `dirs_per_byte` shared-memory bytes per row byte (2 for
// GIGA's two directions, 4 for the packed kernel's four direction rows).
// Stages: the most up to kWideMaxStages that fit beside the whole row's
// directions, but no fewer than kWideInFlight needs; where that does not
// fit, the directions stay out of shared memory (every group fetches them)
// and the ring takes as many stages as fit.  grid: SMs x resident blocks,
// capped at the group count.
inline cudaError_t plan_wide(const void* kernel, long long n, int row_bytes, int dirs_per_byte,
                             WidePlan* out) {
  if (n <= 0 || row_bytes <= 0 || row_bytes % 16) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  size_t budget = 0;
  cudaError_t err = device_limits(&dev, &sms, &budget);
  if (err != cudaSuccess) return err;
  const size_t stage = (size_t)kGroupRows * kPieceBytes;
  const size_t fixed = kBarBytes + kPartBytes;
  int least = (int)((kWideInFlight + stage - 1) / stage);
  if (least < 2) least = 2;
  if (least > kWideMaxStages) least = kWideMaxStages;
  size_t dirs = ((size_t)dirs_per_byte * row_bytes + 127) / 128 * 128;
  int stages = kWideMaxStages;
  while (stages > least && fixed + dirs + stages * stage > budget) --stages;
  if (fixed + dirs + stages * stage > budget) {
    dirs = 0;
    stages = kWideMaxStages;
    while (stages > 2 && fixed + stages * stage > budget) --stages;
    if (fixed + stages * stage > budget) return cudaErrorInvalidConfiguration;
  }
  const size_t smem = fixed + dirs + stages * stage;
  int occ = 0;
  if ((err = resident_blocks(kernel, dev, budget, smem, &occ)) != cudaSuccess) return err;
  const long long groups = (n + kGroupRows - 1) / kGroupRows;
  const long long cap = (long long)sms * occ;
  *out = WidePlan{(int)(groups < cap ? groups : cap), Wide{stages, (int)dirs}, smem};
  return cudaSuccess;
}

// Lane groups: a row of `chunks` 16-byte chunks gets the smallest power of
// two G >= chunks lanes (at most 32), so a warp takes 32/G rows at once.
inline int group_log2(int chunks) {
  int g = 0;
  while ((1 << g) < chunks && g < 5) ++g;
  return g;
}

// The shape of group_reduce's result (see there).
template <int LOG_G, int U>
struct Reduced {
  static constexpr int LOG_V = (U == 1) ? 1 : (U == 2) ? 2 : (U == 4) ? 3 : (U == 8) ? 4 : 5;
  static constexpr int H = LOG_G < LOG_V ? LOG_G : LOG_V;   // transposing steps
  static constexpr int NL = (2 * U) >> H;             // values left per lane
  static constexpr int E = NL >= 2 ? NL / 2 : 1;      // rows per lane
};

// Sums of U rows x 2 values across the G = 2^LOG_G lanes of each group,
// transposed as they are summed: at each of the first H = min(LOG_G,
// log2(2U)) butterfly steps a lane keeps half of its values (the upper half
// if its lane bit is set) and adds its partner's copy of them, so one
// shuffle serves two values.  Afterwards lane L holds NL = 2U >> H sums,
// v[j] for value j + koff(L) (see value_offset); value 2u + d is row u's
// direction d.  Every lane of the warp must call it.
template <int LOG_G, int U, typename Acc>
__device__ __forceinline__ void group_reduce(Acc (&v)[2 * U], int lane) {
  constexpr int H = Reduced<LOG_G, U>::H;
#pragma unroll
  for (int i = 0; i < LOG_G; ++i) {
    const int o = (1 << LOG_G) >> (i + 1);
    if (i < H) {
      const int h = (2 * U) >> (i + 1);
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int j = 0; j < h; ++j) {
        const Acc send = up ? v[j] : v[j + h];
        const Acc keep = up ? v[j + h] : v[j];
        v[j] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xFFFFFFFFu, v[0], o);
    }
  }
}

// koff(L) of group_reduce: the value index of v[0] on lane L.
template <int LOG_G, int U>
__device__ __forceinline__ int value_offset(int lane) {
  constexpr int H = Reduced<LOG_G, U>::H;
  int k = 0;
#pragma unroll
  for (int i = 0; i < H; ++i)
    if (lane & ((1 << LOG_G) >> (i + 1))) k += (2 * U) >> (i + 1);
  return k;
}

// After group_reduce: row u_e = koff/2 + e (e < E) of the step, with its
// two sums (d0, d1).  When one value is left per lane, the other direction
// of its row sits on the partner lane of the last transposing step.  Every
// lane of the warp must call it.
template <int LOG_G, int U, typename Acc>
__device__ __forceinline__ void row_pair(const Acc (&v)[2 * U], int lane, int e, Acc& d0,
                                         Acc& d1) {
  using R = Reduced<LOG_G, U>;
  if constexpr (R::NL >= 2) {
    d0 = v[2 * e];
    d1 = v[2 * e + 1];
  } else {
    const Acc other = __shfl_xor_sync(0xFFFFFFFFu, v[0], (1 << LOG_G) >> R::H);
    const bool is_d1 = (value_offset<LOG_G, U>(lane) & 1) != 0;
    d0 = is_d1 ? other : v[0];
    d1 = is_d1 ? v[0] : other;
  }
}

}  // namespace
