// Banded shift DP for one intron flank, one thread per gap.
//
// Replaces lr2rmats_tpu/ops/splice_device.py:_dp_kernel (Pallas, 128 gaps
// on TPU lanes) and its XLA twin _shift_dp_scan, which the polish placement
// DP runs (lr2rmats_tpu/align/polish.py:_polish_best_pair).  Plain PyTorch
// version: ops/splice.py shift_dp_reference.
//
// What it computes, per gap g with query length m = m[g]:
//   S[0, c]  = -3 (c - B) for c >= B, else NEG
//   diag     = S[j-1, c] + (+1 if q[j-1] == win[j+c-B-1] else -2),
//              NEG unless j+c-B >= 1
//   ins      = S[j-1, c+1] - 3 (NEG for c = W-1)
//   S[j, c]  = sequential deletion scan over c: best = max(best - 3,
//              max(diag, ins)), NEG unless 0 <= j+c-B <= m+B
// for j = 1..M and the W = 2B+1 shifts c.  Out: S [M+1, W, G] float32.
// The values are integers (or the NEG sentinel), so float32 is exact and
// the kernel equals the plain version bit for bit.
//
// What bounds it: M sequential steps per gap, and at polish sizes the write
// of S, (M+1) W G 4 bytes: 3.3 MB per flank at M=192, B=8, G=256.  Design:
// the W row states live in registers (B is a template parameter, so the
// shift loops unroll), each step reads one query code and W window codes,
// and stores are [j, c, g] with g innermost so a warp's stores coalesce.
// q / win are int8 (the polish layout) or int32 (the junction layout).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e18f;          // splice_device.NEG
constexpr float kMatch = 1.0f;
constexpr float kMismatch = -2.0f;
constexpr float kGap = -3.0f;
constexpr int kThreads = 128;

template <int B, typename T>
__global__ void __launch_bounds__(kThreads)
shift_dp_kernel(const T* __restrict__ q, const T* __restrict__ win,
                const int32_t* __restrict__ m, float* __restrict__ S,
                int M, int G) {
  constexpr int W = 2 * B + 1;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const size_t Gs = static_cast<size_t>(G);
  float prev[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    prev[c] = c >= B ? kGap * static_cast<float>(c - B) : kNeg;
    S[c * Gs + g] = prev[c];
  }
  const int hi = m[g] + B;
  for (int j = 1; j <= M; ++j) {
    const T qj = q[(j - 1) * Gs + g];
    float v[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int rlen = j + c - B;
      float diag = kNeg;
      if (rlen >= 1) {
        const T w = win[(rlen - 1) * Gs + g];
        diag = prev[c] + (w == qj ? kMatch : kMismatch);
      }
      const float ins = c + 1 < W ? prev[c + 1] + kGap : kNeg;
      v[c] = fmaxf(diag, ins);
    }
    float best = kNeg;
    float* out = S + static_cast<size_t>(j) * W * Gs + g;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      best = fmaxf(best + kGap, v[c]);
      const int t = j + c - B;
      if (t < 0 || t > hi) best = kNeg;
      prev[c] = best;
      out[c * Gs] = best;
    }
  }
}

template <int B>
int launch_band(const void* q, const void* win, const int32_t* m, float* S,
                int M, int G, int elem_bytes, cudaStream_t stream) {
  const int blocks = (G + kThreads - 1) / kThreads;
  if (elem_bytes == 1) {
    shift_dp_kernel<B, int8_t><<<blocks, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(win), m, S,
        M, G);
  } else if (elem_bytes == 4) {
    shift_dp_kernel<B, int32_t><<<blocks, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(q), static_cast<const int32_t*>(win), m,
        S, M, G);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [M, G]; win: [M+band, G] (int8 when elem_bytes is 1, int32 when 4);
// m: [G] int32; S: [M+1, 2*band+1, G] float32.  band is 4 (junction DP) or
// 8 (polish).  Returns cudaGetLastError().
int lr2_shift_dp(const void* q, const void* win, const void* m, void* S,
                 int M, int G, int band, int elem_bytes, void* stream) {
  if (M < 0 || G < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  const int32_t* mp = static_cast<const int32_t*>(m);
  float* Sp = static_cast<float*>(S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (band) {
    case 4:
      return launch_band<4>(q, win, mp, Sp, M, G, elem_bytes, st);
    case 8:
      return launch_band<8>(q, win, mp, Sp, M, G, elem_bytes, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
