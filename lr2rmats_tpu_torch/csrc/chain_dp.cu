// Splice-aware chaining DP alone (f and parent), one warp per read, any
// number of anchors per read.
//
// Replaces lr2rmats_tpu/ops/chain_pallas.py:_kernel (the windowed chaining
// DP without a backtrack, which the reference drives at every row's own
// width through BatchAligner(backend="pallas") and whose XLA twins are
// chain_jax._chain_scan_T and parallel/mesh.py:_chain_score_local).  Plain
// PyTorch version: ops/chain.py chain_dp_reference.
//
// What it computes, per read b with n = n_anchor[b] anchors sorted by
// (rpos, qpos): f[i] = max(k, max_j f[j] + gain(i, j) - cost(i, j)) over
// the W window predecessors j in [i-W, i) that are valid (0 < dq <=
// max_qgap, 0 < dr <= max_intron); parent[i] = the FIRST j reaching the
// max, or -1.  Slots i >= n get f = -1e18 and parent = -1.  The step
// arithmetic is csrc/chain.cu's, op for op (__fadd_rn / __fmul_rn, so no
// FMA contraction; libdevice log2f, which torch.log2 calls on the card),
// so both kernels and the plain version agree bit for bit.
//
// What bounds it: latency.  Each read is n sequential steps, each a
// W-slot window max and a warp reduction; the data is 8 B per anchor in
// and 8 B out.  chain.cu keeps a whole row in shared memory (16 B per
// anchor), which caps it at 512 anchors.  Here only the last W anchors'
// (q, r, f) stay in a per-warp ring in shared memory (12 * W bytes, 768 B
// at W = 64), so A has no cap: the anchors stream from device memory 32 at
// a time (one coalesced load per lane, broadcast to the warp by shuffles),
// each lane keeps the f / parent of its anchor of the tile in registers,
// and the tile's results go back in one coalesced store.  The reduction
// runs on the predecessor index j, not on the ring slot j % W, so ties
// still go to the smallest j.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;               // reads per block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;          // chain_jax's neg
constexpr int kMaxWindow = 1024;        // 4 rings of 12 * W B under 48 KB

struct DpArgs {
  int window, k, max_qgap, max_intron, min_intron_gap;
  float gap_open, gap_scale, intron_scale;
};

// (value, index) butterfly: max value, ties to the smaller index (the
// first argmax of jnp.argmax and of the plain version)
__device__ __forceinline__ void warp_argmax_first(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
chain_dp_kernel(const int32_t* __restrict__ qpos,
                const int32_t* __restrict__ rpos,
                const int32_t* __restrict__ n_anchor, int B, int A,
                DpArgs p, float* __restrict__ f_out,
                int32_t* __restrict__ parent_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;                   // warp-uniform
  const int W = p.window;
  int32_t* ring_q = reinterpret_cast<int32_t*>(smem) + warp * 3 * W;
  int32_t* ring_r = ring_q + W;
  float* ring_f = reinterpret_cast<float*>(ring_r + W);
  const int n = min(max(n_anchor[b], 0), A);
  const size_t row = static_cast<size_t>(b) * A;
  const float fk = static_cast<float>(p.k);

  for (int base = 0; base < n; base += 32) {
    const int a = base + lane;
    int qa = 0, ra = 0;
    if (a < n) {
      qa = qpos[row + a];
      ra = rpos[row + a];
    }
    float fo = kNeg;
    int po = -1;
    const int cnt = min(32, n - base);
    for (int t = 0; t < cnt; ++t) {
      const int i = base + t;
      const int qi = __shfl_sync(kFull, qa, t);
      const int ri = __shfl_sync(kFull, ra, t);
      float bv = -INFINITY;
      int bj = INT_MAX;
      for (int s = lane; s < W; s += 32) {
        const int j = i - W + s;        // ascends with s
        float sc = kNeg;
        if (j >= 0) {
          const int slot = j % W;
          const int dq = qi - ring_q[slot];
          const int dr = ri - ring_r[slot];
          if (dq > 0 && dr > 0 && dq <= p.max_qgap && dr <= p.max_intron) {
            const float gain = static_cast<float>(min(min(dq, dr), p.k));
            const int dd = dr - dq;
            const float add = static_cast<float>(dd < 0 ? -dd : dd);
            const float lin =
                __fadd_rn(p.gap_open, __fmul_rn(p.gap_scale, add));
            float cost = lin;
            if (dd == 0) {
              cost = 0.0f;
            } else if (dd > p.min_intron_gap) {
              const float logc = __fadd_rn(
                  p.gap_open,
                  __fmul_rn(p.intron_scale, log2f(__fadd_rn(add, 1.0f))));
              cost = fminf(logc, lin);
            }
            sc = __fsub_rn(__fadd_rn(ring_f[slot], gain), cost);
          }
        }
        if (sc > bv) {                  // j ascends: first max per lane
          bv = sc;
          bj = j;
        }
      }
      warp_argmax_first(bv, bj);
      // every lane has read its window slots (their values fed the
      // shuffles above), so anchor i may now take the ring slot of i - W
      if (lane == t) {
        const bool take = bv > fk;
        fo = take ? bv : fk;
        po = take ? bj : -1;
        const int slot = i % W;
        ring_q[slot] = qi;
        ring_r[slot] = ri;
        ring_f[slot] = fo;
      }
      __syncwarp();
    }
    if (a < n) {
      f_out[row + a] = fo;
      parent_out[row + a] = po;
    }
  }
  for (int a = n + lane; a < A; a += 32) {
    f_out[row + a] = kNeg;
    parent_out[row + a] = -1;
  }
}

}  // namespace

extern "C" {

// qpos, rpos, f_out, parent_out: [B, A] row-major; n_anchor: [B].
// Returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernel does not take).
int lr2_chain_dp(const void* qpos, const void* rpos, const void* n_anchor,
                 int B, int A, int window, int k, int max_qgap,
                 int max_intron, int min_intron_gap, float gap_open,
                 float gap_scale, float intron_scale, void* f_out,
                 void* parent_out, void* stream) {
  if (B < 0 || A <= 0 || window <= 0 || window > kMaxWindow ||
      f_out == nullptr || parent_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const DpArgs p{window, k, max_qgap, max_intron, min_intron_gap,
                 gap_open, gap_scale, intron_scale};
  const int blocks = (B + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * 12 * window;
  chain_dp_kernel<<<blocks, kWarps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(rpos),
      static_cast<const int32_t*>(n_anchor), B, A, p,
      static_cast<float*>(f_out), static_cast<int32_t*>(parent_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
