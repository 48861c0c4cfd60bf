// Hamming verify of short-read placements against the resident buffer.
//
// Replaces lr2rmats_tpu/junctions/sjcount_device.py:_mm_kernel (XLA), the
// verify stage of the junction counter (DeviceHammingVerifier.verify).
// Plain PyTorch version: junctions/sjcount_device.py hamming_reference.
//
// What it computes, per candidate i with segment s = rid[i] of the ragged
// read buffer comb / comb_off and p = pos[i]:
//   mm[i] = sum over t < comb_off[s+1] - comb_off[s] of
//           (buf[clip(p+t, 0, n-1)] != comb[comb_off[s] + t])
// The window clips at the buffer ends as _mm_kernel does.  The reference
// pads the reads into a power-of-two matrix for XLA's shape cache; this
// kernel reads the ragged segments directly, with int64 offsets, so it has
// no int32 addressing limit.
//
// What bounds it: bytes.  A candidate reads L (~100-150) bytes of the
// buffer and L of its read and does L compares.  Design: one warp per
// candidate, lane t on bytes t, t+32, ..., so a warp's loads are consecutive
// bytes of both windows; the count is reduced across the warp in registers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;               // candidates per block
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint8_t* __restrict__ buf, long long n,
               const uint8_t* __restrict__ comb,
               const int64_t* __restrict__ comb_off,
               const int32_t* __restrict__ rid,
               const int64_t* __restrict__ pos, long long C,
               int32_t* __restrict__ mm) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= C) return;
  const int s = rid[i];
  const long long lo = comb_off[s];
  const long long len = comb_off[s + 1] - lo;
  const long long p = pos[i];
  int cnt = 0;
  for (long long t = lane; t < len; t += 32) {
    long long b = p + t;
    b = b < 0 ? 0 : (b >= n ? n - 1 : b);
    cnt += buf[b] != comb[lo + t];
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) mm[i] = cnt;
}

}  // namespace

extern "C" {

// buf: [n] uint8; comb: uint8 read segments delimited by comb_off [S+1]
// int64; rid: [C] int32 segment ids; pos: [C] int64; mm: [C] int32 out.
// Returns cudaGetLastError().
int lr2_hamming(const void* buf, long long n, const void* comb,
                const void* comb_off, const void* rid, const void* pos,
                long long C, void* mm, void* stream) {
  if (C < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return static_cast<int>(cudaSuccess);
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (C + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  hamming_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), n, static_cast<const uint8_t*>(comb),
      static_cast<const int64_t*>(comb_off), static_cast<const int32_t*>(rid),
      static_cast<const int64_t*>(pos), C, static_cast<int32_t*>(mm));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
