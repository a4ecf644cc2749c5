// The wscale fold of the GIGA and Frank-Wolfe builds, gated on the device,
// for Hopper (sm_90a).
//
// Replaces the JAX package's lax.cond at bayesian_coresets_tpu/ops/snnls.py:698
// (_carried_commit): where the carried scale would underflow and the step
// commits (a device flag), every weight is multiplied by the scale:
//
//   w[i] *= *scale   for every i,  if *flag;   nothing otherwise.
//
// The build loop is replayed as a CUDA graph with nothing read back per
// iteration, so the host cannot branch on the flag.  Its plain version,
// w.mul_(where(flag, scale, 1.0)), is exact (times 1.0 changes no value) but
// reads and writes all n weights every iteration: at N=8M, 44.5 us, 2.5% of a
// GIGA iteration on the H100.  The fold fires in a build's first iteration
// (alpha == 0) and rarely after, so this kernel reads the flag and every
// block returns at once when it is clear: the launch's fixed cost alone.
// When it is set it is bound by bytes (n floats read and written once):
// float4 loads and stores, a grid-stride loop over at most 4 blocks of 256
// threads per SM.  The product is the one f32 multiply PyTorch's mul makes,
// so the weights are the plain version's bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
    fold_scale_kernel(float* __restrict__ w, long long n, const bool* __restrict__ flag,
                      const float* __restrict__ scale) {
  if (!*flag) return;
  const float s = *scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = (reinterpret_cast<uintptr_t>(w) % 16 == 0) ? n / 4 : 0;
  float4* w4 = reinterpret_cast<float4*>(w);
  for (long long j = first; j < n4; j += stride) {
    float4 v = w4[j];
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    w4[j] = v;
  }
  for (long long j = 4 * n4 + first; j < n; j += stride) w[j] *= s;
}

}  // namespace

// w: n contiguous f32 (any alignment); flag: one bool; scale: one f32; all
// on the device of `stream`.  One launch on `stream`; never synchronizes;
// returns cudaGetLastError().
extern "C" int fold_scale_launch(void* w, long long n, const void* flag, const void* scale,
                                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long want = (n / 4 + kFoldThreads - 1) / kFoldThreads;
  const int grid = (int)(want < 1 ? 1 : (want < 4ll * sms ? want : 4ll * sms));
  fold_scale_kernel<<<grid, kFoldThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float*>(w), n, reinterpret_cast<const bool*>(flag),
      reinterpret_cast<const float*>(scale));
  return (int)cudaGetLastError();
}
