// Fused splice-aware chaining DP + backtrack, one warp per read.
//
// Replaces lr2rmats_tpu/ops/chain_pallas.py:_kernel (the windowed chaining
// DP, 128 reads on TPU lanes) and lr2rmats_tpu/ops/chain_jax.py:
// _backtrack_core (its XLA twin _scan_core fused with the primary /
// secondary backtrack).  Plain PyTorch version: ops/chain.py
// chain_dp_backtrack_reference.
//
// What it computes, per read b with n = n_anchor[b] anchors sorted by
// (rpos, qpos):
//   f[i] = max(k, max_j f[j] + gain(i, j) - cost(i, j)) over the W window
//   predecessors j in [i-W, i) that are valid (0 < dq <= max_qgap,
//   0 < dr <= max_intron); parent[i] = the FIRST j reaching the max, or -1.
//   Then, as chain_jax._backtrack_core does: pe = first argmax f; the
//   primary chain is the parent path from pe (when f[pe] >= min_score);
//   reach[a] = on_primary[a] | reach[parent[a]]; se = first argmax of f over
//   scorable anchors with no path into the primary; the secondary chain is
//   kept when fewer than 48 overlapping candidates rank ahead of se (the
//   host backtrack's examine cap, align/chain.py:backtrack).
//   Out: mask[b, a] (bit0 primary, bit1 secondary), ps[b], ss[b] (0 when
//   the chain is absent) and, when f_out is not null, f / parent.
//
// Arithmetic: float32 like the TPU kernel.  Every add and multiply is an
// explicit round-to-nearest intrinsic (__fadd_rn/__fmul_rn), so nvcc cannot
// contract them into FMAs and the result equals the plain PyTorch version,
// which runs one elementwise op per step.  log2f is the CUDA math library's
// accurate log2f (libdevice __nv_log2f, at most 1 ulp; not the __log2f
// intrinsic, since no --use_fast_math); torch.log2 on a CUDA float tensor
// calls the same function.  On the CPU, torch.log2 and the reference's
// jnp.log2 (log(x)/log(2) in XLA) differ by an ulp on some inputs, which is
// why the CPU tests hold f at a tolerance and parents exactly.
//
// What bounds it: latency, not bandwidth.  Each read is A sequential steps
// (A <= 128 on the main path), each a 64-slot window max; the data is 8 B
// per anchor in and 1 B out (about 1.7 MB per 1664 x 128 chunk).  Design:
// one warp per read with the read's q, r, f and parent in shared memory
// (16 B per anchor), each lane holding window slots l and l+32, and a
// shuffle max + first-index reduction per step; the backtrack runs in the
// same launch on the same shared arrays, so nothing but the mask and the
// two scores goes back to device memory.  Four reads per block of 128
// threads gives 416 blocks for the 1664-row chunk.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;               // reads per block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;          // chain_jax's neg
constexpr int kMaxExamine = 48;         // align/chain.py:backtrack cap
constexpr int kMaxA = 512;              // keeps 4 reads under 48 KB smem

struct ChainArgs {
  int window, k, max_qgap, max_intron, min_intron_gap;
  float gap_open, gap_scale, intron_scale, min_score;
};

__host__ __device__ inline int warp_stride_bytes(int A) {
  return 16 * A + ((A + 15) & ~15);
}

// (value, index) butterfly: max value, ties to the smaller index, so every
// lane ends with the FIRST argmax (jnp.argmax / host stable-sort order).
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
chain_dp_backtrack_kernel(const int32_t* __restrict__ qpos,
                          const int32_t* __restrict__ rpos,
                          const int32_t* __restrict__ n_anchor,
                          int B, int A, ChainArgs p,
                          uint8_t* __restrict__ mask,
                          float* __restrict__ ps_out,
                          float* __restrict__ ss_out,
                          float* __restrict__ f_out,
                          int32_t* __restrict__ parent_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;                   // warp-uniform
  unsigned char* base = smem + warp * warp_stride_bytes(A);
  int32_t* q = reinterpret_cast<int32_t*>(base);
  int32_t* r = q + A;
  float* f = reinterpret_cast<float*>(r + A);
  int32_t* par = reinterpret_cast<int32_t*>(f + A);
  uint8_t* flag = reinterpret_cast<uint8_t*>(par + A);  // 1 pri, 2 reach, 4 sec
  const int n = min(max(n_anchor[b], 0), A);
  const size_t row = static_cast<size_t>(b) * A;
  const float fk = static_cast<float>(p.k);
  for (int a = lane; a < A; a += 32) {
    q[a] = qpos[row + a];
    r[a] = rpos[row + a];
    f[a] = fk;
    par[a] = -1;
    flag[a] = 0;
  }
  __syncwarp();

  // ---- DP (chain_jax._scan_core / chain_pallas._kernel) ----
  for (int i = 0; i < n; ++i) {
    const int qi = q[i];
    const int ri = r[i];
    float bv = -INFINITY;
    int bj = INT_MAX;
    for (int s = lane; s < p.window; s += 32) {
      const int j = i - p.window + s;
      float sc = kNeg;
      if (j >= 0) {
        const int dq = qi - q[j];
        const int dr = ri - r[j];
        if (dq > 0 && dr > 0 && dq <= p.max_qgap && dr <= p.max_intron) {
          const float gain = static_cast<float>(min(min(dq, dr), p.k));
          const int dd = dr - dq;
          const float add = static_cast<float>(dd < 0 ? -dd : dd);
          const float lin = __fadd_rn(p.gap_open, __fmul_rn(p.gap_scale, add));
          float cost = lin;
          if (dd == 0) {
            cost = 0.0f;
          } else if (dd > p.min_intron_gap) {
            const float logc = __fadd_rn(
                p.gap_open,
                __fmul_rn(p.intron_scale, log2f(__fadd_rn(add, 1.0f))));
            cost = fminf(logc, lin);
          }
          sc = __fsub_rn(__fadd_rn(f[j], gain), cost);
        }
      }
      if (sc > bv) {                    // slots ascend: first max per lane
        bv = sc;
        bj = j;
      }
    }
    warp_argmax_first(bv, bj);
    if (lane == 0 && bv > f[i]) {
      f[i] = bv;
      par[i] = bj;
    }
    __syncwarp();
  }

  // ---- backtrack (chain_jax._backtrack_core) ----
  float pv = -INFINITY;
  int pe = INT_MAX;
  for (int a = lane; a < n; a += 32) {
    if (f[a] > pv) {
      pv = f[a];
      pe = a;
    }
  }
  warp_argmax_first(pv, pe);
  const bool p_ok = n > 0 && pv >= p.min_score;
  if (lane == 0 && p_ok) {
    for (int a = pe; a >= 0; a = par[a]) flag[a] |= 1;
    // parent[a] < a, so one forward pass settles reach
    for (int a = 0; a < n; ++a) {
      const int pa = par[a];
      if ((flag[a] & 1) || (pa >= 0 && (flag[pa] & 2))) flag[a] |= 2;
    }
  }
  __syncwarp();
  float sv = -INFINITY;
  int se = INT_MAX;
  if (p_ok) {
    for (int a = lane; a < n; a += 32) {
      const float fa = f[a];
      if (fa >= p.min_score && !(flag[a] & 2) && fa > sv) {
        sv = fa;
        se = a;
      }
    }
  }
  warp_argmax_first(sv, se);
  const bool any_disj = sv > -INFINITY;
  int ahead = 0;
  if (any_disj) {
    // overlapping candidates the host would examine before se
    for (int a = lane; a < n; a += 32) {
      const float fa = f[a];
      const uint8_t fl = flag[a];
      if (fa >= p.min_score && (fl & 2) && !(fl & 1) &&
          (fa > sv || (fa == sv && a < se)))
        ++ahead;
    }
  }
  ahead = __reduce_add_sync(kFull, ahead);
  const bool s_ok = any_disj && ahead < kMaxExamine;
  if (lane == 0 && s_ok) {
    for (int a = se; a >= 0; a = par[a]) flag[a] |= 4;
  }
  __syncwarp();
  for (int a = lane; a < A; a += 32) {
    const uint8_t fl = flag[a];
    mask[row + a] = static_cast<uint8_t>((fl & 1) | ((fl >> 1) & 2));
    if (f_out != nullptr) {
      f_out[row + a] = a < n ? f[a] : kNeg;
      parent_out[row + a] = a < n ? par[a] : -1;
    }
  }
  if (lane == 0) {
    ps_out[b] = p_ok ? pv : 0.0f;
    ss_out[b] = s_ok ? sv : 0.0f;
  }
}

}  // namespace

extern "C" {

// qpos, rpos, mask, f_out, parent_out: [B, A] row-major; n_anchor, ps, ss:
// [B].  f_out and parent_out may be null.  Returns cudaGetLastError().
int lr2_chain_dp_backtrack(const void* qpos, const void* rpos,
                           const void* n_anchor, int B, int A,
                           int window, int k, int max_qgap, int max_intron,
                           int min_intron_gap, float gap_open,
                           float gap_scale, float intron_scale,
                           float min_score, void* mask, void* ps, void* ss,
                           void* f_out, void* parent_out, void* stream) {
  if (B < 0 || A <= 0 || A > kMaxA || window <= 0 ||
      (f_out == nullptr) != (parent_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const ChainArgs p{window, k, max_qgap, max_intron, min_intron_gap,
                    gap_open, gap_scale, intron_scale, min_score};
  const int blocks = (B + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * warp_stride_bytes(A);
  chain_dp_backtrack_kernel<<<blocks, kWarps * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(rpos),
      static_cast<const int32_t*>(n_anchor), B, A, p,
      static_cast<uint8_t*>(mask), static_cast<float*>(ps),
      static_cast<float*>(ss), static_cast<float*>(f_out),
      static_cast<int32_t*>(parent_out));
  return static_cast<int>(cudaGetLastError());
}

const char* lr2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
