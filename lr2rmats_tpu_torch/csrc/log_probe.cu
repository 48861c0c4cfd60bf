// The log probe of the chain-parity diagnostic: y = ln(x) * log2(e)
// elementwise over float32.
//
// Replaces scripts/diag_chain_pallas.py:log_probe's `kern` (a Pallas
// kernel over [S, 128] f32 computing jnp.log(x) * LOG2E, the log2 form the
// Pallas chain DP uses).  Plain PyTorch version: diag/chain_parity.py
// log_probe_reference (torch.log(x) * LOG2E).
//
// Arithmetic: logf is the CUDA math library's accurate function (libdevice
// __nv_logf; no --use_fast_math), which torch.log calls on a CUDA float
// tensor; the product is one __fmul_rn by log2(e) rounded to float32
// (0x1.715476p+0), as torch multiplies a float32 tensor by a Python float.
//
// What bounds it: device-memory bandwidth, 8 B per element; at the
// diagnostic's 37376 elements (0.30 MB) the bytes take ~0.1 us and the
// time is one launch's.  So the kernel does the least a launch can: one
// thread takes four neighbouring elements through one 16-byte load and one
// 16-byte store (neighbouring threads on neighbouring addresses), the grid
// covers n / 4 exactly, and no thread loops.  The last thread takes the
// n mod 4 tail one element at a time; where x or y is not 16-byte aligned
// (a view such as x[1:] sits 4 bytes off) every thread takes one element.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kLog2e = 0x1.715476p+0f;
constexpr int kThreads = 256;

__device__ __forceinline__ float probe(float v) {
  return __fmul_rn(logf(v), kLog2e);
}

// kVec: thread t takes elements 4t .. 4t + 3; else element t.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
log_probe_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long n) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (kVec) {
    const long long i = 4 * t;
    if (i + 4 <= n) {
      float4 v = reinterpret_cast<const float4*>(x)[t];
      v.x = probe(v.x);
      v.y = probe(v.y);
      v.z = probe(v.z);
      v.w = probe(v.w);
      reinterpret_cast<float4*>(y)[t] = v;
    } else {
      for (long long k = i; k < n; ++k) y[k] = probe(x[k]);
    }
  } else if (t < n) {
    y[t] = probe(x[t]);
  }
}

}  // namespace

extern "C" {

// x, y: n float32; y = ln(x) * log2(e).  Returns cudaGetLastError().
int lr2_log_probe(const void* x, void* y, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long threads = vec ? (n + 3) / 4 : n;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  auto* yp = static_cast<float*>(y);
  if (vec)
    log_probe_kernel<true><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        xp, yp, n);
  else
    log_probe_kernel<false><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        xp, yp, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
