// Banded shift DP for one intron flank, a group of lanes per gap.
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
//
// What bounds it: M dependent steps per gap, and the write of S, (M+1) W G
// 4 bytes (6.7 MB at the polish shape M=192, B=8, G=512).  Design, for
// Hopper:
//   - L lanes per gap (16 for B=4, W=9; 32 for B=8, W=17), lane c holding
//     shift c, so G=512 polish gaps are 512 warps instead of 4 blocks of
//     threads.  Lane c forms diag from its own S[j-1, c] and ins from
//     S[j-1, c+1], which one __shfl_down_sync brings from lane c+1.
//   - The deletion scan is a max-plus prefix scan over the lanes:
//     u_c = v_c + 3c (NEG on the lanes where j+c-B < 0, since the
//     sequential scan restarts there), best_c = prefix-max(u)_c - 3c, NEG
//     where j+c-B > m+B.  It equals the sequential scan bit for bit: every
//     finite score is a small integer, exact in float32, and NEG +- 3c
//     rounds back to NEG (-1e18).
//   - A block of GPB = 128 / L gaps stages its gaps' query and window
//     columns in shared memory once, and stages K steps of its
//     [W x GPB] output tiles; every K steps the block writes them out as
//     rows of GPB consecutive g (double-buffered, one __syncthreads).
// q / win are int8 (the polish layout) or int32 (the junction layout).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;          // splice_device.NEG
constexpr float kMatch = 1.0f;
constexpr float kMismatch = -2.0f;
constexpr float kGap = -3.0f;
constexpr int kThreads = 128;
constexpr int kSteps = 16;              // S rows staged per write-out
constexpr int kSmemCap = 48 * 1024;

template <int B>
struct Band {
  static constexpr int W = 2 * B + 1;
  static constexpr int L = W <= 16 ? 16 : 32;     // lanes per gap
  static constexpr int GPB = kThreads / L;         // gaps per block
  static constexpr int SP = GPB + 1;               // padded code row
};

template <int B, typename T>
size_t smem_bytes(int M) {
  using Bd = Band<B>;
  return static_cast<size_t>(2 * kSteps * Bd::W * Bd::GPB) * sizeof(float) +
         static_cast<size_t>(2 * M + B) * Bd::SP * sizeof(T);
}

template <int B, typename T>
__global__ void __launch_bounds__(kThreads)
shift_dp_kernel(const T* __restrict__ q, const T* __restrict__ win,
                const int32_t* __restrict__ m, float* __restrict__ S,
                int M, int G) {
  using Bd = Band<B>;
  constexpr int W = Bd::W, L = Bd::L, GPB = Bd::GPB, SP = Bd::SP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);   // [2][kSteps][W][GPB]
  T* qs = reinterpret_cast<T*>(stage + 2 * kSteps * W * GPB);  // [M][SP]
  T* ws = qs + static_cast<size_t>(M) * SP;                     // [M+B][SP]
  const int g0 = blockIdx.x * GPB;
  const size_t Gs = static_cast<size_t>(G);

  // query and window columns of the block's gaps (coalesced along g)
  for (int e = threadIdx.x; e < (2 * M + B) * GPB; e += kThreads) {
    const int rw = e / GPB, col = e % GPB, g = g0 + col;
    T v = 0;
    if (g < G) v = rw < M ? q[rw * Gs + g] : win[(rw - M) * Gs + g];
    qs[rw * SP + col] = v;              // ws follows qs: row M is win row 0
  }

  const int c = threadIdx.x & (L - 1);  // shift
  const int gi = threadIdx.x / L;       // gap in the block
  const int g = g0 + gi;
  const bool lane_on = c < W;
  const int hi = (g < G ? m[g] : 0) + B;
  const float c3 = static_cast<float>(3 * c);
  float prev = c >= B && lane_on ? kGap * static_cast<float>(c - B) : kNeg;
  __syncthreads();

  // write-out: thread tid stores column tid % GPB of staged rows tid / GPB,
  // tid / GPB + kThreads / GPB, ...
  const int col = threadIdx.x % GPB;
  const bool col_on = g0 + col < G;
  const size_t row_step = static_cast<size_t>(kThreads / GPB) * Gs;
  auto flush = [&](int j0, int rows, const float* buf) {
    __syncthreads();
    float* dst = S + (static_cast<size_t>(j0) * W + threadIdx.x / GPB) * Gs +
                 g0 + col;
    for (int rc = threadIdx.x / GPB; rc < rows * W;
         rc += kThreads / GPB, dst += row_step)
      if (col_on) *dst = buf[rc * GPB + col];
  };

  // the codes of step j, loaded a step ahead
  T q_next = M > 0 ? qs[gi] : T(0);
  T w_next = 1 + c - B >= 1 && lane_on ? ws[(c - B) * SP + gi] : T(0);
  for (int j = 0; j <= M; ++j) {
    if (j > 0) {
      const T qj = q_next;
      const T w = w_next;
      const int rlen = j + c - B;
      if (j < M) {
        q_next = qs[j * SP + gi];
        w_next = rlen + 1 >= 1 && lane_on ? ws[rlen * SP + gi] : T(0);
      }
      const float diag =
          rlen >= 1 && lane_on ? prev + (w == qj ? kMatch : kMismatch) : kNeg;
      const float up = __shfl_down_sync(kFull, prev, 1, L);
      const float ins = c + 1 < W ? up + kGap : kNeg;
      const float v = fmaxf(diag, ins);
      const int t = j + c - B;
      float u = t < 0 || !lane_on ? kNeg : __fadd_rn(v, c3);
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const float o = __shfl_up_sync(kFull, u, off, L);
        if (c >= off) u = fmaxf(u, o);
      }
      prev = t < 0 || t > hi || !lane_on ? kNeg : __fsub_rn(u, c3);
    }
    float* buf = stage + ((j / kSteps) & 1) * kSteps * W * GPB;
    if (lane_on) buf[((j % kSteps) * W + c) * GPB + gi] = prev;
    if (j % kSteps == kSteps - 1 || j == M)
      flush(j - j % kSteps, j % kSteps + 1, buf);
  }
}

template <int B, typename T>
int launch_kernel(const void* q, const void* win, const int32_t* m, float* S,
                  int M, int G, cudaStream_t stream) {
  const size_t smem = smem_bytes<B, T>(M);
  if (smem > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (G + Band<B>::GPB - 1) / Band<B>::GPB;
  shift_dp_kernel<B, T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(win), m, S, M, G);
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int launch_band(const void* q, const void* win, const int32_t* m, float* S,
                int M, int G, int elem_bytes, cudaStream_t stream) {
  if (elem_bytes == 1)
    return launch_kernel<B, int8_t>(q, win, m, S, M, G, stream);
  if (elem_bytes == 4)
    return launch_kernel<B, int32_t>(q, win, m, S, M, G, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q: [M, G]; win: [M+band, G] (int8 when elem_bytes is 1, int32 when 4);
// m: [G] int32; S: [M+1, 2*band+1, G] float32.  band is 4 (junction DP) or
// 8 (polish).  Refuses an M whose staged columns exceed 48 KB of shared
// memory.  Returns cudaGetLastError().
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
