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
// tensor; the product is
// one __fmul_rn by log2(e) rounded to float32 (0x1.715476p+0), as torch
// multiplies a float32 tensor by a Python float.
//
// What bounds it: device-memory bandwidth, 8 B per element; at the
// diagnostic's 37376 elements it is one launch's latency.  One thread per
// element, grid-stride.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kLog2e = 0x1.715476p+0f;

__global__ void log_probe_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    y[i] = __fmul_rn(logf(x[i]), kLog2e);
  }
}

}  // namespace

extern "C" {

// x, y: n float32; y = ln(x) * log2(e).  Returns cudaGetLastError().
int lr2_log_probe(const void* x, void* y, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  log_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
