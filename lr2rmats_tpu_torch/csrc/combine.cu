// Junction combine: best (j, cl, cr) joint placement per gap.
//
// Replaces lr2rmats_tpu/ops/splice_device.py:_combine (XLA), which the
// reference's junction backends (junction_batch_scan, junction_batch_pallas)
// run after both flank shift DPs.  Plain PyTorch version: ops/junction.py
// combine_reference.
//
// What it computes, per gap g with m = m[g], over j in [0, M] and
// cl, cr in [0, W), W = 2B+1:
//   v = SL[j,cl] + SR[clip(m-j,0,M),cr] + bonus(dok[j+cl], aok[a])
//       - 0.375 max(el-(j+cl-B), 0) - 0.375 max(er-(m-j+cr-B), 0),
//   a = clip(m-j+cr, 0, M+2B), evaluated left to right, each op rounded to
//   float32 (no FMA contraction), as the plain version's elementwise ops;
//   v = NEG where j > m, a class < 0, or span-m+2B-(cl+cr) < min_intron.
// The argmax over the flat index (j*W + cl)*W + cr takes the LARGEST index
// among equal maxima (the reference's tie rule, the opposite of the chain
// kernel's).  Out: score, j, cl, cr, vote (of the chosen cell's classes) and
// found = score > NEG/2.  Every value is an integer or a multiple of 3/8,
// so the result equals the plain version bit for bit, not-found lanes (near
// -1e18) included.
//
// What bounds it: (M+1) W W = 5265 cells a gap at M = 64, B = 4, over
// inputs of (M+1) W 4 bytes a flank (2.3 KB), read with G innermost.
// Design: a block takes kTile consecutive gaps and stages their SL / SR /
// dok / aok columns in shared memory with consecutive threads on
// consecutive gaps (one 32-byte sector a row); then one warp takes one gap,
// each lane walks its (j, cl) pairs in increasing order with the W values
// of cr unrolled, keeps (value, flat index), and the warp reduces with the
// same comparator by shuffles.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNeg = -1e18f;          // splice_device.NEG
constexpr float kHalfNeg = -5e17f;      // NEG / 2, the found threshold
constexpr float kWPos = 0.375f;         // align/splice.py W_POS
constexpr int kTile = 8;                // gaps per block, one warp each
constexpr int kThreads = kTile * 32;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void motif(int dc, int ac, float* bonus,
                                      int* vote) {
  const bool canon_p = dc == 1 && ac == 1;
  const bool canon_m = dc == 2 && ac == 2;
  const bool semi_p = (dc == 3 && ac == 1) || (dc == 4 && ac == 2);
  const bool semi_m = (dc == 2 && ac == 3) || (dc == 1 && ac == 4);
  *bonus = (canon_p || canon_m) ? 10.0f : ((semi_p || semi_m) ? 8.0f : 0.0f);
  *vote = ((canon_p || semi_p) ? 1 : 0) - ((canon_m || semi_m) ? 1 : 0);
}

// (v, f) beats (bv, bf): larger value, then larger flat index
__device__ __forceinline__ bool beats(float v, int f, float bv, int bf) {
  return v > bv || (v == bv && f > bf);
}

template <int B>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ SL, const float* __restrict__ SR,
               const int32_t* __restrict__ m, const int64_t* __restrict__ span,
               const int8_t* __restrict__ dok, const int8_t* __restrict__ aok,
               const int32_t* __restrict__ el, const int32_t* __restrict__ er,
               int M, int G, long long min_intron, float* __restrict__ score,
               int32_t* __restrict__ bj, int32_t* __restrict__ bcl,
               int32_t* __restrict__ bcr, int32_t* __restrict__ vote,
               uint8_t* __restrict__ found) {
  constexpr int W = 2 * B + 1;
  const int R = (M + 1) * W;            // rows of SL / SR
  const int Mc = M + 2 * B + 1;         // rows of dok / aok
  extern __shared__ float smem[];
  float* sl = smem;                                       // [kTile][R]
  float* sr = sl + kTile * R;                             // [kTile][R]
  int8_t* sd = reinterpret_cast<int8_t*>(sr + kTile * R);  // [kTile][Mc]
  int8_t* sa = sd + kTile * Mc;
  const int g0 = blockIdx.x * kTile;
  const int nt = min(kTile, G - g0);
  const size_t Gs = static_cast<size_t>(G);
  for (int i = threadIdx.x; i < kTile * R; i += kThreads) {
    const int t = i % kTile, r = i / kTile;
    if (t < nt) {
      sl[t * R + r] = SL[r * Gs + g0 + t];
      sr[t * R + r] = SR[r * Gs + g0 + t];
    }
  }
  for (int i = threadIdx.x; i < kTile * Mc; i += kThreads) {
    const int t = i % kTile, r = i / kTile;
    if (t < nt) {
      sd[t * Mc + r] = dok[r * Gs + g0 + t];
      sa[t * Mc + r] = aok[r * Gs + g0 + t];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= nt) return;
  const int g = g0 + warp;
  const int mg = m[g];
  const long long ilen0 = span[g] - mg + 2 * B;
  const int elg = el[g], erg = er[g];
  const float* L = sl + warp * R;
  const float* Rt = sr + warp * R;
  const int8_t* D = sd + warp * Mc;
  const int8_t* A = sa + warp * Mc;
  float best = -INFINITY;
  int bestf = -1;
  for (int p = lane; p < R; p += 32) {      // p = j*W + cl, increasing
    const int j = p / W, cl = p - j * W;
    const int dc = D[j + cl];
    const float slv = L[p];
    const float pen_l = __fmul_rn(
        kWPos, static_cast<float>(max(elg - (j + cl - B), 0)));
    const int srow = min(max(mg - j, 0), M);
#pragma unroll
    for (int cr = 0; cr < W; ++cr) {
      const int ac = A[min(max(mg - j + cr, 0), Mc - 1)];
      float v = kNeg;
      if (j <= mg && dc >= 0 && ac >= 0 && ilen0 - (cl + cr) >= min_intron) {
        float bonus;
        int vt;
        motif(dc, ac, &bonus, &vt);
        const float pen_r = __fmul_rn(
            kWPos, static_cast<float>(max(erg - (mg - j + cr - B), 0)));
        v = __fsub_rn(
            __fsub_rn(__fadd_rn(__fadd_rn(slv, Rt[srow * W + cr]), bonus),
                      pen_l),
            pen_r);
      }
      if (v >= best) {                        // later cells win ties
        best = v;
        bestf = p * W + cr;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int of = __shfl_xor_sync(0xffffffffu, bestf, off);
    if (beats(ov, of, best, bestf)) {
      best = ov;
      bestf = of;
    }
  }
  if (lane == 0) {
    const int j = bestf / (W * W);
    const int cl = (bestf / W) % W;
    const int cr = bestf % W;
    float bonus;
    int vt;
    motif(D[j + cl], A[min(max(mg - j + cr, 0), Mc - 1)], &bonus, &vt);
    score[g] = best;
    bj[g] = j;
    bcl[g] = cl;
    bcr[g] = cr;
    vote[g] = vt;
    found[g] = best > kHalfNeg ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// SL, SR: [M+1, 2B+1, G] float32; m, el, er: [G] int32; span: [G] int64;
// dok, aok: [M+2B+1, G] int8.  Out: score [G] float32; bj, bcl, bcr, vote
// [G] int32; found [G] uint8 (bool).  B must be 4.  Returns
// cudaGetLastError().
int lr2_combine(const void* SL, const void* SR, const void* m,
                const void* span, const void* dok, const void* aok,
                const void* el, const void* er, int M, int G, int B,
                long long min_intron, void* score, void* bj, void* bcl,
                void* bcr, void* vote, void* found, void* stream) {
  if (M < 0 || G < 0 || B != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  constexpr int W = 2 * 4 + 1;
  const size_t smem = static_cast<size_t>(kTile) *
                      (2 * static_cast<size_t>(M + 1) * W * sizeof(float) +
                       2 * static_cast<size_t>(M + 2 * 4 + 1));
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        combine_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (G + kTile - 1) / kTile;
  combine_kernel<4><<<blocks, kThreads, smem, static_cast<cudaStream_t>(
                                                  stream)>>>(
      static_cast<const float*>(SL), static_cast<const float*>(SR),
      static_cast<const int32_t*>(m), static_cast<const int64_t*>(span),
      static_cast<const int8_t*>(dok), static_cast<const int8_t*>(aok),
      static_cast<const int32_t*>(el), static_cast<const int32_t*>(er), M, G,
      min_intron, static_cast<float*>(score), static_cast<int32_t*>(bj),
      static_cast<int32_t*>(bcl), static_cast<int32_t*>(bcr),
      static_cast<int32_t*>(vote), static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
