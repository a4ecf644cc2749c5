// One GIGA iteration's arithmetic around the select, for Hopper (sm_90a):
// two single-block kernels that take the place of the ~165 small PyTorch
// kernels of ops/snnls.py's _giga_step, _carried_commit and the loop's
// gating.  A replayed iteration is then four graph nodes:
//
//   giga_step_dirs_kernel    the select's directions [cdir_n, xw_n] (S, 2)
//                            of the state (xw, bxw, nw2)
//   giga_select_kernel       (csrc/giga_select.cu, unchanged)
//   giga_step_update_kernel  the selected row, the reweight, the new xw and
//                            its scalar cache, the monotone check, the
//                            support slots, the where-gated commit and the
//                            loop's fail / done / itr under
//                            live = (itr < itr_end) & !done
//   fold_scale_kernel        (csrc/fold_scale.cu, unchanged)
//   giga_step_dirs_kernel    again: first the one weight write w[f] = raw
//                            where the step committed (after the fold, as
//                            _carried_commit orders them: when the fold
//                            fires the written weight is new_wf itself),
//                            then the next iteration's directions
//
// so a segment of m iterations is 1 + 4 m launches (ops/giga_step.py).
//
// They replace no Pallas kernel: on the TPU, XLA fused these ops into the
// while loop's body (bayesian_coresets_tpu/ops/snnls.py:_giga_step; a v5e
// iteration took <= 44 us, select included, BENCH_r05.json).  What bounds
// them on the H100 is latency, not bytes or operations: they move a few KB
// (at S = 500: xw, b, the directions and one row of V, ~8 KB, 2.4 ns at
// 3.35 TB/s) through a chain of dependent loads and block-wide reductions.
// So each is one block that loops over S (any S the builds use, up to
// 16384), reduces in registers, warp shuffles and shared memory, and keeps
// every intermediate vector out of device memory: the update kernel makes
// the candidate xw twice (once for its sums, once to commit it) rather
// than store it.
//
// Numerics are those of the PyTorch ops, bit for bit:
//   - every f32 operation goes through __fadd_rn / __fsub_rn / __fmul_rn /
//     __fdiv_rn, so nvcc contracts nothing into an FMA;
//   - every square root is __fsqrt_rn, the correctly rounded f32 root that
//     ops/giga_select.py's sqrt_rn takes through float64;
//   - every dot (snnls._dot, _sdots) is accumulated in float64 and rounded
//     to f32: the products of f32 values are exact in f64, and only the
//     order of the f64 sum differs from the plain version's, which moves
//     the f32 result only when the f64 sum lies within a few f64 ulps of an
//     f32 rounding boundary;
//   - clamp_min keeps NaN (PyTorch's clamp), and tol, 1 + tol and the fold
//     floor come in as the f32 values that PyTorch compares and multiplies
//     with.
// Both kernels run on PyTorch's current stream, allocate nothing and read
// nothing back, so they are capture-safe; every sum is taken in one fixed
// order, so a replay gives the direct run's bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float clamp0(float x) { return isnan(x) ? x : fmaxf(x, 0.0f); }

__device__ __forceinline__ float one_if_zero(float x) { return x == 0.0f ? 1.0f : x; }

__device__ __forceinline__ double dot_term(float x, float y) {
  return __dmul_rn((double)x, (double)y);
}

// The select's frame of the state (giga_step.frame): b's norm and xw's, each
// 1 where 0, bxwn = <b/|b|, xw/|xw|> and the norm of cdir = bn - bxwn xwn.
struct Frame {
  float bnorm, nw, bxwn, cdirnrm;
};

__device__ __forceinline__ Frame frame(float bnorm, float bxw, float nw2) {
  Frame fr;
  fr.bnorm = one_if_zero(bnorm);
  fr.nw = one_if_zero(__fsqrt_rn(clamp0(nw2)));
  fr.bxwn = __fdiv_rn(bxw, __fmul_rn(fr.bnorm, fr.nw));
  fr.cdirnrm = __fsqrt_rn(clamp0(__fsub_rn(1.0f, __fmul_rn(fr.bxwn, fr.bxwn))));
  return fr;
}

// Sums N float64 values over the block, in one fixed order; every thread
// gets the totals.  `sh` is reused: the trailing barrier keeps the next
// call's writes after this call's reads.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double (*sh)[kWarps]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] = __dadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) sh[k][warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    double s = 0.0;
    for (int j = 0; j < kWarps; ++j) s = __dadd_rn(s, sh[k][j]);
    v[k] = s;
  }
  __syncthreads();
}

struct DirsArgs {
  const float* b;
  long long b_stride;
  const float* bnorm;
  const float* xw;
  const float* bxw;
  const float* nw2;
  int S;
  float2* dirs;
  // the pending weight write of the step before, or w == nullptr for none
  float* w;
  const int* f;
  const bool* commit;
  const float* raw;
};

__global__ void __launch_bounds__(kThreads) giga_step_dirs_kernel(DirsArgs a) {
  if (a.w != nullptr && threadIdx.x == 0 && *a.commit) a.w[*a.f] = *a.raw;
  const Frame fr = frame(*a.bnorm, *a.bxw, *a.nw2);
  const float den = one_if_zero(fr.cdirnrm);
  for (int i = threadIdx.x; i < a.S; i += kThreads) {
    const float bn = __fdiv_rn(a.b[i * a.b_stride], fr.bnorm);
    const float xwn = __fdiv_rn(a.xw[i], fr.nw);
    const float cdir = __fsub_rn(bn, __fmul_rn(fr.bxwn, xwn));
    a.dirs[i] = make_float2(__fdiv_rn(cdir, den), xwn);
  }
}

struct UpdateArgs {
  const void* V;  // (n, S) rows, f32 or int8-resident (row r = q_r * norms[r] / 127)
  int int8;
  long long ldv;  // V's row stride, in elements
  const float* norms;
  const float* b;
  long long b_stride;
  const float* bnorm;
  int S, K;
  const int* f;  // the select's index
  const float* w;
  float* xw;
  int* idcs;
  int* size;
  int* itr;
  const int* itr_end;
  int* fail;
  bool* done;
  float* bxw;
  float* nw2;
  float* err;
  float* wscale;
  float tol, tol1, floor;  // f32(tol), f32(1 + tol), f32(the fold floor)
  bool* commit;            // the work: commit, fold & commit, ws2, raw
  bool* fold;
  float* ws2;
  float* raw;
};

__global__ void __launch_bounds__(kThreads) giga_step_update_kernel(UpdateArgs a) {
  __shared__ double sh[3][kWarps];
  const int t = threadIdx.x;
  // every value that thread 0 writes at the end is read here, before the
  // first barrier
  const int f = *a.f;
  const int size = *a.size, itr = *a.itr, fail = *a.fail;
  const bool done = *a.done;
  const bool live = itr < *a.itr_end && !done;
  const float bxw = *a.bxw, nw2 = *a.nw2, err = *a.err, ws = *a.wscale;
  const Frame fr = frame(*a.bnorm, bxw, nw2);
  const bool ok_sel = fr.cdirnrm >= a.tol;
  const float nf = a.norms[f];
  const float old_raw = a.w[f];
  const float nq = __fmul_rn(nf, (float)(1.0 / 127.0));  // snnls._rows' dequantization
  const float* vf = static_cast<const float*>(a.V) + (long long)f * a.ldv;
  const int8_t* qf = static_cast<const int8_t*>(a.V) + (long long)f * a.ldv;
  auto xf_at = [&](int i) { return a.int8 ? __fmul_rn((float)qf[i], nq) : vf[i]; };

  // <bn, xfn>, <xwn, xfn>, and whether f already holds a live slot
  double d[3] = {0.0, 0.0, 0.0};
  for (int i = t; i < a.S; i += kThreads) {
    const float xfn = __fdiv_rn(xf_at(i), nf);
    const float bn = __fdiv_rn(a.b[i * a.b_stride], fr.bnorm);
    const float xwn = __fdiv_rn(a.xw[i], fr.nw);
    d[0] = __dadd_rn(d[0], dot_term(bn, xfn));
    d[1] = __dadd_rn(d[1], dot_term(xwn, xfn));
  }
  for (int k = t; k < a.K; k += kThreads)
    if (k < size && a.idcs[k] == f) d[2] = 1.0;
  block_sum<3>(d, sh);
  const float bxf = __double2float_rn(d[0]), xwxf = __double2float_rn(d[1]);
  const bool already = d[2] > 0.0;

  // the reweight (giga_step.reweight; reference giga.py:40-64)
  const float gA = __fsub_rn(bxf, __fmul_rn(fr.bxwn, xwxf));
  const float gB = __fsub_rn(fr.bxwn, __fmul_rn(bxf, xwxf));
  const bool ok_rw = gA > 0.0f && gB >= 0.0f;
  const float gsum = one_if_zero(__fadd_rn(gA, gB));
  const float ca = __fdiv_rn(__fdiv_rn(gB, gsum), fr.nw);
  const float cc = __fdiv_rn(__fdiv_rn(gA, gsum), nf);
  const float xw_xf = __fmul_rn(__fmul_rn(fr.nw, nf), xwxf);
  const float b_xf = __fmul_rn(__fmul_rn(fr.bnorm, nf), bxf);
  const float nx2 =
      __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ca, ca), nw2),
                          __fmul_rn(__fmul_rn(__fmul_rn(2.0f, ca), cc), xw_xf)),
                __fmul_rn(__fmul_rn(__fmul_rn(cc, cc), nf), nf));
  const float x_b = __fadd_rn(__fmul_rn(ca, bxw), __fmul_rn(cc, b_xf));
  const float scale = __fdiv_rn(x_b, one_if_zero(nx2));
  const float alpha = __fmul_rn(ca, scale), beta = __fmul_rn(cc, scale);
  const float old_wf = __fmul_rn(ws, old_raw);
  const float new_wf = clamp0(__fadd_rn(__fmul_rn(alpha, old_wf), beta));
  const float delta = __fsub_rn(new_wf, __fmul_rn(alpha, old_wf));

  // the candidate xw2 = alpha xw + delta xf and its cache (snnls._aux_from_xw)
  double e[3] = {0.0, 0.0, 0.0};
  for (int i = t; i < a.S; i += kThreads) {
    const float bi = a.b[i * a.b_stride];
    const float x2 = __fadd_rn(__fmul_rn(alpha, a.xw[i]), __fmul_rn(delta, xf_at(i)));
    const float r = __fsub_rn(x2, bi);
    e[0] = __dadd_rn(e[0], dot_term(bi, x2));
    e[1] = __dadd_rn(e[1], dot_term(x2, x2));
    e[2] = __dadd_rn(e[2], dot_term(r, r));
  }
  block_sum<3>(e, sh);
  const float bxw2 = __double2float_rn(e[0]), nw22 = __double2float_rn(e[1]);
  const float err2 = __fsqrt_rn(__double2float_rn(e[2]));

  // the monotone check, the slots (snnls._track_support) and the gates
  const bool overflow = !already && size >= a.K;
  const bool keep = already || overflow;
  const bool monotone = !(size > 0) || err2 <= __fmul_rn(err, a.tol1);
  const bool ok = ok_sel && ok_rw && monotone && isfinite(err2);
  const bool commit = ok && !overflow && live;
  const float ws2 = __fmul_rn(alpha, ws);
  const bool fold = ws2 < a.floor;

  if (commit)  // each thread commits the entries it read
    for (int i = t; i < a.S; i += kThreads)
      a.xw[i] = __fadd_rn(__fmul_rn(alpha, a.xw[i]), __fmul_rn(delta, xf_at(i)));
  if (t == 0) {
    if (commit) {
      if (!keep) a.idcs[min(size, a.K - 1)] = f;
      *a.size = keep ? size : size + 1;
      *a.bxw = bxw2;
      *a.nw2 = nw22;
      *a.err = err2;
      *a.wscale = fold ? 1.0f : ws2;
    }
    const int fail2 = ok ? 0 : fail + 1;
    if (live) {
      *a.fail = fail2;
      *a.done = fail2 >= 2 || overflow;
      *a.itr = itr + 1;
    }
    *a.commit = commit;
    *a.fold = fold && commit;
    *a.ws2 = ws2;
    *a.raw = fold ? new_wf : __fdiv_rn(new_wf, ws2);
  }
}

int launch_error() { return (int)cudaGetLastError(); }

}  // namespace

// The directions of the state into dirs ((S, 2) f32, 8-byte aligned), after
// the pending weight write w[*f] = *raw where *commit (w == nullptr: none).
// One single-block launch on `stream`; never synchronizes; returns
// cudaGetLastError().
extern "C" int giga_step_dirs_launch(const void* b, long long b_stride, const void* bnorm,
                                     const void* xw, const void* bxw, const void* nw2, int S,
                                     void* dirs, void* w, const void* f, const void* commit,
                                     const void* raw, void* stream) {
  DirsArgs a{static_cast<const float*>(b),     b_stride,
             static_cast<const float*>(bnorm), static_cast<const float*>(xw),
             static_cast<const float*>(bxw),   static_cast<const float*>(nw2),
             S,                                static_cast<float2*>(dirs),
             static_cast<float*>(w),           static_cast<const int*>(f),
             static_cast<const bool*>(commit), static_cast<const float*>(raw)};
  giga_step_dirs_kernel<<<1, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return launch_error();
}

// One GIGA step after the select, committed in place where it commits and
// the loop's gates allow; the weight write and the fold's flag and scale go
// to the work (commit, fold, ws2, raw).  Pointers as ops/giga_step.py
// checks them; one single-block launch on `stream`; never synchronizes;
// returns cudaGetLastError().
extern "C" int giga_step_update_launch(
    const void* V, int int8, long long ldv, const void* norms, const void* b, long long b_stride,
    const void* bnorm, int S, int K, const void* f, const void* w, void* xw, void* idcs,
    void* size, void* itr, const void* itr_end, void* fail, void* done, void* bxw, void* nw2,
    void* err, void* wscale, float tol, float tol1, float floor, void* commit, void* fold,
    void* ws2, void* raw, void* stream) {
  UpdateArgs a{V,
               int8,
               ldv,
               static_cast<const float*>(norms),
               static_cast<const float*>(b),
               b_stride,
               static_cast<const float*>(bnorm),
               S,
               K,
               static_cast<const int*>(f),
               static_cast<const float*>(w),
               static_cast<float*>(xw),
               static_cast<int*>(idcs),
               static_cast<int*>(size),
               static_cast<int*>(itr),
               static_cast<const int*>(itr_end),
               static_cast<int*>(fail),
               static_cast<bool*>(done),
               static_cast<float*>(bxw),
               static_cast<float*>(nw2),
               static_cast<float*>(err),
               static_cast<float*>(wscale),
               tol,
               tol1,
               floor,
               static_cast<bool*>(commit),
               static_cast<bool*>(fold),
               static_cast<float*>(ws2),
               static_cast<float*>(raw)};
  giga_step_update_kernel<<<1, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return launch_error();
}
