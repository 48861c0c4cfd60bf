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
// explicit round-to-nearest intrinsic (__fadd_rn/__fmul_rn/__fsub_rn), so
// nvcc cannot contract them into FMAs and the result equals the plain
// PyTorch version, which runs one elementwise op per step.  log2f is the
// CUDA math library's accurate log2f (libdevice __nv_log2f; not the __log2f
// intrinsic, since no --use_fast_math); torch.log2 on a CUDA float tensor
// calls the same function.  The score is (f[j] + gain) - cost with gain and
// cost kept apart: a folded gain - cost would round differently.
//
// What bounds it: latency and instruction issue, not bandwidth.  Each read
// is n sequential steps, each a max over the W-slot window (about 9.3 M
// predecessor pairs a main-path launch of 1664 reads); the data is 8 B per
// anchor in and 1 B out.  Design, for Hopper:
//   - One warp per read, each lane holding S = R / 32 window slots in
//     registers.  The slots form a ring indexed by j mod R (R >= W, a power
//     of two): the anchor computed at step i lands in slot i mod R and
//     stays there until it leaves the window, so nothing shifts between
//     lanes.  Every predecessor of a row of A <= 512 anchors lies fewer
//     than A steps back, so a window of A or more is taken as A and the
//     widest ring has 512 slots.
//   - The work that does not depend on f (validity, gain and the cost) is
//     computed a tile of anchors ahead, into registers, in a straight-line
//     block that the compiler interleaves with the dependent steps of the
//     current tile.  The cost depends on dd = dr - dq alone, so it is read
//     from a table of cost(dd) over every dd a valid pair can have, filled
//     on the card by the same expression (libdevice log2f, a software
//     routine of ~45 instructions, included) when the chain parameters
//     change: the same bits for a fraction of the instructions.  The table
//     is one per card; a lock held from the check of its parameters until
//     the launch is queued, and a refill that first waits for the card,
//     keep every launch on the table of its own parameters.  Parameters
//     whose dd range exceeds kCostTable take the inline expression.
//   - A step is S adds and an argmax over the warp that leaves the new
//     f[i] in every lane: two redux instructions (the max of an
//     order-preserving int key, then the least index holding it)
//     in place of a 5-round (value, index) shuffle butterfly.  The lane
//     that owns slot i mod R takes f[i] from its own register, with no
//     shared-memory round trip or __syncwarp.  f and parent also go to
//     shared memory for the backtrack, off the dependent path.
//   - Ties keep the first index: in a lane's slots and across lanes.
//   - The backtrack's reach pass runs by pointer jumping over the lanes
//     (log2 n rounds) instead of one lane's forward pass; the two parent
//     paths stay one lane's walks (doubling them measured slower).
// The backtrack runs in the same launch on the read's shared arrays, so only
// the mask and the two scores go back to device memory.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;          // chain_jax's neg
constexpr int kMaxExamine = 48;         // align/chain.py:backtrack cap
constexpr int kMaxA = 512;              // a block's reads stay under 48 KB
constexpr int kBlockThreads = 128;
constexpr int kSmemCap = 48 * 1024;
constexpr int kTilePairs = 8;           // (anchor, slot) pairs a lane
                                        // precomputes per tile
constexpr int kCostTable = 1 << 19;     // entries of the cost(dd) table
constexpr int kMaxCards = 64;

struct ChainArgs {
  int window, k, max_qgap, max_intron, min_intron_gap;
  float gap_open, gap_scale, intron_scale, min_score;
};

// cost(dd + max_qgap) for dd in [-max_qgap, max_intron): every dd of a valid
// pair (0 < dq <= max_qgap, 0 < dr <= max_intron)
__device__ float g_cost[kCostTable];
// held from ensure_cost_table until the launch that reads the table is
// queued
std::mutex g_cost_mu;

__device__ __forceinline__ float gap_cost(int dd, const ChainArgs& p) {
  const float add = static_cast<float>(dd < 0 ? -dd : dd);
  const float lin = __fadd_rn(p.gap_open, __fmul_rn(p.gap_scale, add));
  float cost = lin;
  if (dd == 0) {
    cost = 0.0f;
  } else if (dd > p.min_intron_gap) {
    const float logc = __fadd_rn(
        p.gap_open, __fmul_rn(p.intron_scale, log2f(__fadd_rn(add, 1.0f))));
    cost = fminf(logc, lin);
  }
  return cost;
}

__global__ void fill_cost_table(ChainArgs p, int size) {
  for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < size;
       x += gridDim.x * blockDim.x)
    g_cost[x] = gap_cost(x - p.max_qgap, p);
}

__host__ __device__ inline int read_stride_bytes(int A) {
  return 16 * A + ((A + 15) & ~15);
}

// A float as an int whose signed order is the float's order (no NaN, and
// -0 below +0, which no score takes), and back: the map is its own inverse.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Max value over the warp, ties to the smaller index, so every lane ends
// with the FIRST argmax: the max key, then the least index holding it.
__device__ __forceinline__ void warp_argmax_first(float& v, int& idx) {
  const int key = order_key(v);
  const int best = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == best ? idx : INT_MAX);
  v = __int_as_float(order_key(__int_as_float(best)));
}

// The f-independent part of T anchors' window slots held by one lane.
template <int T, int S>
struct Tile {
  float gain[T][S];
  float cost[T][S];
  uint32_t valid;                       // bit t * S + s
};

// The predecessor that slot s of lane ln holds at step i: the j in
// [i - R, i) with j = ln * S + s (mod R).
template <int S, int R>
__device__ __forceinline__ int slot_j(int i, int ln, int s) {
  return i - R + ((ln * S + s - i) & (R - 1));
}

template <int T, int S, int R, bool kTable>
__device__ __forceinline__ void precompute(Tile<T, S>& tl, int i0, int ln,
                                           int A, const int32_t* q,
                                           const int32_t* r,
                                           const ChainArgs& p) {
  tl.valid = 0u;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = i0 + t;
    const bool live = i < A;
    const int qi = q[live ? i : 0];
    const int ri = r[live ? i : 0];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = slot_j<S, R>(i, ln, s);
      const bool in_win = live && j >= 0 && i - j <= p.window;
      const int jj = in_win ? j : 0;
      const int dq = qi - q[jj];
      const int dr = ri - r[jj];
      // 0 < dq <= max_qgap and 0 < dr <= max_intron, one compare each
      const bool ok = in_win &&
                      static_cast<unsigned>(dq - 1) <
                          static_cast<unsigned>(p.max_qgap) &&
                      static_cast<unsigned>(dr - 1) <
                          static_cast<unsigned>(p.max_intron);
      if (kTable) {
        const unsigned at =
            min(static_cast<unsigned>(dr) - static_cast<unsigned>(dq) +
                    static_cast<unsigned>(p.max_qgap),
                static_cast<unsigned>(kCostTable - 1));
        tl.cost[t][s] = __ldg(&g_cost[at]);
      } else {
        tl.cost[t][s] = gap_cost(dr - dq, p);
      }
      tl.gain[t][s] = static_cast<float>(min(min(dq, dr), p.k));
      tl.valid |= ok ? (1u << (t * S + s)) : 0u;
    }
  }
}

template <int S, bool kTable>
__global__ void chain_dp_backtrack_kernel(const int32_t* __restrict__ qpos,
                                          const int32_t* __restrict__ rpos,
                                          const int32_t* __restrict__ n_anchor,
                                          int B, int A, ChainArgs p,
                                          uint8_t* __restrict__ mask,
                                          float* __restrict__ ps_out,
                                          float* __restrict__ ss_out,
                                          float* __restrict__ f_out,
                                          int32_t* __restrict__ parent_out) {
  constexpr int R = 32 * S;
  constexpr int T = kTilePairs / S > 0 ? kTilePairs / S : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ln = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;                   // the whole warp: no block barrier
  unsigned char* base = smem + warp * read_stride_bytes(A);
  int32_t* q = reinterpret_cast<int32_t*>(base);
  int32_t* r = q + A;
  float* f = reinterpret_cast<float*>(r + A);
  int32_t* par = reinterpret_cast<int32_t*>(f + A);
  // 1 primary, 2 reach, 4 secondary, 8 reach staged
  uint8_t* flag = reinterpret_cast<uint8_t*>(par + A);
  const int n = min(max(n_anchor[b], 0), A);
  const size_t row = static_cast<size_t>(b) * A;
  const float fk = static_cast<float>(p.k);
  for (int a = ln; a < A; a += 32) {
    q[a] = qpos[row + a];
    r[a] = rpos[row + a];
    f[a] = fk;
    par[a] = -1;
    flag[a] = 0;
  }
  __syncwarp();

  // ---- DP (chain_jax._scan_core / chain_pallas._kernel) ----
  float ring[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ring[s] = 0.0f;
  Tile<T, S> cur, nxt;
  precompute<T, S, R, kTable>(cur, 0, ln, A, q, r, p);
  for (int i0 = 0; i0 < n; i0 += T) {
    precompute<T, S, R, kTable>(nxt, i0 + T, ln, A, q, r, p);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = i0 + t;
      float bv = -INFINITY;
      int bj = INT_MAX;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = slot_j<S, R>(i, ln, s);
        const float sc =
            (cur.valid >> (t * S + s)) & 1u
                ? __fsub_rn(__fadd_rn(ring[s], cur.gain[t][s]), cur.cost[t][s])
                : kNeg;
        if (sc > bv || (sc == bv && j < bj)) {
          bv = sc;
          bj = j;
        }
      }
      warp_argmax_first(bv, bj);
      const bool take = bv > fk;
      const float fi = take ? bv : fk;
      const int owner = (i & (R - 1)) / S;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (ln == owner && s == (i & (S - 1))) ring[s] = fi;
      if (ln == 0 && i < n) {
        f[i] = fi;
        par[i] = take ? bj : -1;
      }
    }
    cur = nxt;
  }
  __syncwarp();

  // ---- backtrack (chain_jax._backtrack_core) ----
  float pv = -INFINITY;
  int pe = INT_MAX;
  for (int a = ln; a < n; a += 32) {
    if (f[a] > pv) {
      pv = f[a];
      pe = a;
    }
  }
  warp_argmax_first(pv, pe);
  const bool p_ok = n > 0 && pv >= p.min_score;
  if (ln == 0 && p_ok) {
    for (int a = pe; a >= 0; a = par[a]) flag[a] |= 1;
  }
  __syncwarp();
  // reach[a] = on_primary[a] | reach[parent[a]], by pointer jumping: after
  // round r, bit 2 holds the OR over a's first 2^r ancestors (itself
  // included) and up[a] its 2^r-th ancestor.  q / r are free after the DP.
  const int n_reach = p_ok ? n : 0;
  int32_t* up = q;
  int32_t* up_next = r;
  for (int a = ln; a < n_reach; a += 32) {
    up[a] = par[a];
    if (flag[a] & 1) flag[a] |= 2;
  }
  __syncwarp();
  for (int span = 1; span < n_reach; span <<= 1) {
    for (int a = ln; a < n_reach; a += 32) {
      const int u = up[a];
      int u_next = u;
      if (!(flag[a] & 2) && u >= 0) {
        if (flag[u] & 2) flag[a] |= 8;  // bit 2 of this round, staged
        u_next = up[u];
      }
      up_next[a] = u_next;
    }
    __syncwarp();
    for (int a = ln; a < n_reach; a += 32)
      if (flag[a] & 8) flag[a] |= 2;
    int32_t* t = up;
    up = up_next;
    up_next = t;
    __syncwarp();
  }
  float sv = -INFINITY;
  int se = INT_MAX;
  if (p_ok) {
    for (int a = ln; a < n; a += 32) {
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
    for (int a = ln; a < n; a += 32) {
      const float fa = f[a];
      const uint8_t fl = flag[a];
      if (fa >= p.min_score && (fl & 2) && !(fl & 1) &&
          (fa > sv || (fa == sv && a < se)))
        ++ahead;
    }
  }
  ahead = __reduce_add_sync(kFull, ahead);
  const bool s_ok = any_disj && ahead < kMaxExamine;
  if (ln == 0 && s_ok) {
    for (int a = se; a >= 0; a = par[a]) flag[a] |= 4;
  }
  __syncwarp();
  for (int a = ln; a < A; a += 32) {
    const uint8_t fl = flag[a];
    mask[row + a] = static_cast<uint8_t>((fl & 1) | ((fl >> 1) & 2));
    if (f_out != nullptr) {
      f_out[row + a] = a < n ? f[a] : kNeg;
      parent_out[row + a] = a < n ? par[a] : -1;
    }
  }
  if (ln == 0) {
    ps_out[b] = p_ok ? pv : 0.0f;
    ss_out[b] = s_ok ? sv : 0.0f;
  }
}

// Reads (warps) per block: up to kBlockThreads / 32, under kSmemCap of
// shared memory; 0 when one read does not fit.
int reads_per_block(int A) {
  const int fit = kSmemCap / read_stride_bytes(A);
  return kBlockThreads / 32 < fit ? kBlockThreads / 32 : fit;
}

// Fills the cost table on the current card for the parameters p, unless it
// already holds them.  A refill waits for the card, so no launch still reads
// the old table.  The caller holds g_cost_mu until its launch is queued.
int ensure_cost_table(const ChainArgs& p, cudaStream_t stream) {
  struct Held {
    bool filled;
    int max_qgap, max_intron, min_intron_gap;
    float gap_open, gap_scale, intron_scale;
  };
  static Held held[kMaxCards];
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (card >= kMaxCards) return static_cast<int>(cudaErrorInvalidDevice);
  Held& h = held[card];
  if (h.filled && h.max_qgap == p.max_qgap && h.max_intron == p.max_intron &&
      h.min_intron_gap == p.min_intron_gap && h.gap_open == p.gap_open &&
      h.gap_scale == p.gap_scale && h.intron_scale == p.intron_scale)
    return static_cast<int>(cudaSuccess);
  h.filled = false;
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = p.max_qgap + p.max_intron;
  if (size > 0) {
    fill_cost_table<<<(size + 255) / 256, 256, 0, stream>>>(p, size);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  h = Held{true, p.max_qgap, p.max_intron, p.min_intron_gap,
           p.gap_open, p.gap_scale, p.intron_scale};
  return static_cast<int>(cudaSuccess);
}

template <int S>
int launch(const int32_t* qpos, const int32_t* rpos, const int32_t* n_anchor,
           int B, int A, const ChainArgs& p, uint8_t* mask, float* ps,
           float* ss, float* f_out, int32_t* parent_out,
           cudaStream_t stream) {
  const int rpb = reads_per_block(A);
  if (rpb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(rpb) * read_stride_bytes(A);
  if (p.max_qgap >= 0 && p.max_intron >= 0 &&
      static_cast<long long>(p.max_qgap) + p.max_intron <= kCostTable) {
    std::lock_guard<std::mutex> hold(g_cost_mu);
    const int rc = ensure_cost_table(p, stream);
    if (rc != 0) return rc;
    chain_dp_backtrack_kernel<S, true><<<blocks, rpb * 32, smem, stream>>>(
        qpos, rpos, n_anchor, B, A, p, mask, ps, ss, f_out, parent_out);
    return static_cast<int>(cudaGetLastError());
  }
  chain_dp_backtrack_kernel<S, false><<<blocks, rpb * 32, smem, stream>>>(
      qpos, rpos, n_anchor, B, A, p, mask, ps, ss, f_out, parent_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qpos, rpos, mask, f_out, parent_out: [B, A] row-major; n_anchor, ps, ss:
// [B].  f_out and parent_out may be null.  Refuses A > 512; a window of A
// or more is taken as A.  Returns cudaGetLastError().
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
  // every predecessor lies fewer than A steps back
  window = window < A ? window : A;
  const ChainArgs p{window, k, max_qgap, max_intron, min_intron_gap,
                    gap_open, gap_scale, intron_scale, min_score};
  const auto* qp = static_cast<const int32_t*>(qpos);
  const auto* rp = static_cast<const int32_t*>(rpos);
  const auto* np_ = static_cast<const int32_t*>(n_anchor);
  auto* mk = static_cast<uint8_t*>(mask);
  auto* psp = static_cast<float*>(ps);
  auto* ssp = static_cast<float*>(ss);
  auto* fo = static_cast<float*>(f_out);
  auto* po = static_cast<int32_t*>(parent_out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (window <= 64)                     // the main path (ChainParams.window)
    return launch<2>(qp, rp, np_, B, A, p, mk, psp, ssp, fo, po, st);
  if (window <= 256)
    return launch<8>(qp, rp, np_, B, A, p, mk, psp, ssp, fo, po, st);
  return launch<16>(qp, rp, np_, B, A, p, mk, psp, ssp, fo, po, st);
}

const char* lr2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
