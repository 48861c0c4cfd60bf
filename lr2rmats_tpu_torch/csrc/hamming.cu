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
// buffer and L of its read and does L compares.  Design, for Hopper:
//   - 8 lanes a candidate (4 a warp), each on 4-byte words: lane k takes
//     words k, k+8, ... of the read, counted from its segment's start
//     rounded down to 4 bytes, so every read-side load is an aligned word
//     that holds at least one byte of the segment (never past the
//     allocation, whose base the wrapper keeps 4-byte aligned).
//   - The buffer side of a word starts at p - (lo & 3) + 4k, at the same
//     offset within its word for every k: two aligned loads and one
//     __funnelshift_r give it.  The 8 lanes' loads are consecutive words.
//   - __vcmpne4 marks differing bytes (0xff each); the first and last
//     words are masked to the segment's bytes; __popc / 8 counts them.
//     The 8 lanes' counts meet in one redux.
//   - Only a candidate whose window comes within 4 bytes of the buffer's
//     start or 8 of its end (p < 4 or p + len + 8 > n) takes the clipped
//     byte-by-byte path, which also keeps the word loads inside the buffer.
//   - 64-bit arithmetic for the base addresses only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 8;               // lanes a candidate (< 32)
constexpr int kThreads = 256;
constexpr int kPerBlock = kThreads / kLanes;

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint8_t* __restrict__ buf, long long n,
               const uint8_t* __restrict__ comb,
               const int64_t* __restrict__ comb_off,
               const int32_t* __restrict__ rid,
               const int64_t* __restrict__ pos, long long C,
               int32_t* __restrict__ mm) {
  const long long i = static_cast<long long>(blockIdx.x) * kPerBlock +
                      (threadIdx.x / kLanes);
  if (i >= C) return;                   // the whole group leaves together
  const int k0 = threadIdx.x % kLanes;
  const unsigned group = ((1u << kLanes) - 1u)
                         << (threadIdx.x & 31 & ~(kLanes - 1));
  const int s = rid[i];
  const long long lo = comb_off[s];
  const int len = static_cast<int>(comb_off[s + 1] - lo);
  const long long p = pos[i];
  int bits = 0;                         // 8 per differing byte
  if (p < 4 || p + len + 8 > n) {
    for (int t = k0; t < len; t += kLanes) {
      long long b = p + t;
      b = b < 0 ? 0 : (b >= n ? n - 1 : b);
      bits += buf[b] != comb[lo + t] ? 8 : 0;
    }
  } else if (len > 0) {
    const int d = static_cast<int>(lo & 3);        // segment start in word
    const unsigned* cw = reinterpret_cast<const unsigned*>(comb + (lo - d));
    const long long bstart = p - d;                 // >= 1
    const int sh = static_cast<int>(bstart & 3) * 8;
    const unsigned* bw = reinterpret_cast<const unsigned*>(buf + (bstart & ~3LL));
    const int end = d + len;                        // segment end, in bytes
    const int nw = (end + 3) >> 2;
    for (int k = k0; k < nw; k += kLanes) {
      const unsigned a = cw[k];
      const unsigned b = __funnelshift_r(bw[k], bw[k + 1], sh);
      unsigned diff = __vcmpne4(a, b);
      if (k == 0) diff &= 0xffffffffu << (8 * d);
      const int rest = end - 4 * k;                 // bytes of the segment
      if (rest < 4) diff &= (1u << (8 * rest)) - 1u;
      bits += __popc(diff);
    }
  }
  bits = __reduce_add_sync(group, bits);
  if (k0 == 0) mm[i] = bits >> 3;
}

}  // namespace

extern "C" {

// buf: [n] uint8; comb: uint8 read segments delimited by comb_off [S+1]
// int64; rid: [C] int32 segment ids; pos: [C] int64; mm: [C] int32 out.
// buf and comb must start on a 4-byte boundary.  Returns
// cudaGetLastError().
int lr2_hamming(const void* buf, long long n, const void* comb,
                const void* comb_off, const void* rid, const void* pos,
                long long C, void* mm, void* stream) {
  if (C < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return static_cast<int>(cudaSuccess);
  if (n == 0 || (reinterpret_cast<uintptr_t>(buf) & 3) ||
      (reinterpret_cast<uintptr_t>(comb) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (C + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  hamming_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), n, static_cast<const uint8_t*>(comb),
      static_cast<const int64_t*>(comb_off), static_cast<const int32_t*>(rid),
      static_cast<const int64_t*>(pos), C, static_cast<int32_t*>(mm));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
