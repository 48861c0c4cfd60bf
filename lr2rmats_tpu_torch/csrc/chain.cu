// Splice-aware chaining DP, one warp per read, in two kernels that share
// one step loop: fused with the backtrack for rows of up to 512 anchors
// (lr2_chain_dp_backtrack), and the DP alone at any number of anchors
// (lr2_chain_dp).
//
// Replaces lr2rmats_tpu/ops/chain_pallas.py:_kernel (the windowed chaining
// DP, 128 reads on TPU lanes).  The fused kernel also replaces
// lr2rmats_tpu/ops/chain_jax.py:_backtrack_core (its XLA twin _scan_core
// fused with the primary / secondary backtrack); the DP alone is what the
// reference drives at every row's own width through
// BatchAligner(backend="pallas"), with the XLA twins
// chain_jax._chain_scan_T and parallel/mesh.py:_chain_score_local.  Plain
// PyTorch versions: ops/chain.py chain_dp_backtrack_reference and
// chain_dp_reference.
//
// What it computes, per read b with n = n_anchor[b] anchors sorted by
// (rpos, qpos):
//   f[i] = max(k, max_j f[j] + gain(i, j) - cost(i, j)) over the W window
//   predecessors j in [i-W, i) that are valid (0 < dq <= max_qgap,
//   0 < dr <= max_intron); parent[i] = the FIRST j reaching the max, or -1.
//   The DP alone writes f / parent, with -1e18 / -1 in slots n..A-1.
//   The fused kernel then, as chain_jax._backtrack_core does: pe = first
//   argmax f; the primary chain is the parent path from pe (when f[pe] >=
//   min_score); reach[a] = on_primary[a] | reach[parent[a]]; se = first
//   argmax of f over scorable anchors with no path into the primary; the
//   secondary chain is kept when fewer than 48 overlapping candidates rank
//   ahead of se (the host backtrack's examine cap, align/chain.py:
//   backtrack).  Out: mask[b, a] (bit0 primary, bit1 secondary), ps[b],
//   ss[b] (0 when the chain is absent) and, when f_out is not null, f /
//   parent.
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
// What bounds it: the latency of each read's n dependent steps, not
// bandwidth.  Each step is a max over the W-slot window (about 9.3 M
// predecessor pairs a main-path launch of 1664 reads); the data is 8 B per
// anchor in and 1 B (fused) or 8 B (DP alone) out.  Design, for Hopper:
//   - One warp per read, each lane holding S = R / 32 window slots in
//     registers.  The slots form a ring indexed by j mod R (R >= W, a power
//     of two), slot m in lane m mod 32, so the lanes of one register hold
//     neighbouring anchors and their (q, r) loads are free of bank
//     conflicts: the f computed at step i lands in slot i mod R of the lane
//     that owns it, from its own register (a select on a one-bit mask, so
//     the ring stays in registers), and stays there until it leaves the
//     window, so nothing shifts between lanes and no shared memory or
//     __syncwarp sits on the dependent path.  Every predecessor lies fewer
//     than A steps back, so a window of A or more is taken as A.
//   - The work that does not depend on f (the window test, validity by two
//     unsigned compares, gain, and the cost) is computed a tile of anchors
//     ahead (kTilePairs slots a lane: 8 anchors at S = 2), into registers.
//     The cost depends on dd = dr - dq alone, so it is read from a table of
//     cost(dd) over every dd a valid pair can have, filled on the card by
//     the same expression (libdevice log2f, a software routine of ~45
//     instructions, included) when the chain parameters change: the same
//     bits for a fraction of the instructions.  An invalid pair reads the
//     table's last entry, +inf, so the step needs no validity test.  The
//     table is one per card, shared by both kernels; a lock held from the
//     check of its parameters until the launch is queued, and a refill that
//     first waits for the card, keep every launch on the table of its own
//     parameters.  Parameters whose dd range exceeds kCostTable take the
//     inline expression.
//   - A step is S adds, the lane's max and one redux of its order key,
//     which leaves the new f[i] in every lane; the parent, the least index
//     holding the max (a second redux), is off the dependent path.  Ties
//     keep the first index: in a lane's slots and across lanes.
//   - Where a predecessor's (q, r) comes from is the only difference
//     between the two kernels' step loops (dp_steps over a Rows accessor):
//       fused: the whole row, staged in shared memory with f / parent for
//       the backtrack (16 B an anchor + 1, so A <= 512 under 48 KB a
//       block of four reads);
//       DP alone: a per-warp circular buffer of Q anchors (Q >= R + 64, a
//       power of two; 8 B each), filled 32 anchors at a time by cp.async,
//       one coalesced 4-byte copy a lane and array.  The copy of chunk c+1
//       is issued when the lookahead enters chunk c, so it lands during
//       the 32 dependent steps before it is read, and A has no cap.  Each
//       lane keeps its step of the current 32 in registers and the chunk
//       goes out in one coalesced store per array.
//   - The fused kernel's backtrack runs in the same launch on the read's
//     shared arrays, so only the mask and the two scores go back to device
//     memory; its reach pass runs by pointer jumping over the lanes (log2 n
//     rounds) instead of one lane's forward pass; the two parent paths stay
//     one lane's walks (doubling them measured slower).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;          // chain_jax's neg
constexpr int kMaxExamine = 48;         // align/chain.py:backtrack cap
constexpr int kMaxA = 512;              // a block's reads stay under 48 KB
constexpr int kMaxWindow = 1024;        // the DP alone: the widest ring
constexpr int kBlockThreads = 128;
constexpr int kSmemCap = 48 * 1024;
constexpr int kTilePairs = 16;          // (anchor, slot) pairs a lane
                                        // precomputes per tile
constexpr int kCostTable = 1 << 19;     // entries of the cost(dd) table
constexpr int kMaxCards = 64;

struct ChainArgs {
  int window, k, max_qgap, max_intron, min_intron_gap;
  float gap_open, gap_scale, intron_scale, min_score;
};

// cost(dd + max_qgap) for dd in [-max_qgap, max_intron): every dd of a valid
// pair (0 < dq <= max_qgap, 0 < dr <= max_intron); then +inf, the cost of
// an invalid pair
__device__ float g_cost[kCostTable + 1];
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
  if (blockIdx.x == 0 && threadIdx.x == 0) g_cost[kCostTable] = INFINITY;
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

// The f-independent part of T anchors' window slots held by one lane.  An
// invalid pair costs +inf, so its score is -inf: below every valid score
// (which exceeds -1e18) as the plain version's -1e18 is, and never taken.
template <int T, int S>
struct Tile {
  float gain[T][S];
  float cost[T][S];
};

// The predecessor that slot s of lane ln holds at step i is the j in
// [i - R, i) with j = 32 * s + ln (mod R): j = i - R + slot_off.  Lanes
// hold neighbouring slots, so a slot's (q, r) loads over the warp are free
// of bank conflicts.
template <int R>
__device__ __forceinline__ int slot_off(int i, int ln, int s) {
  return (32 * s + ln - i) & (R - 1);
}

template <int T, int S, int R, bool kTable, class Rows>
__device__ __forceinline__ void precompute(Tile<T, S>& tl, int i0, int ln,
                                           int n, const Rows& rows,
                                           const ChainArgs& p) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = i0 + t;
    const bool live = i < n;
    const int qi = rows.q(live ? i : 0);
    const int ri = rows.r(live ? i : 0);
    // slot s holds j = i - R + off, in the window (0 <= j, i - j <=
    // window) when off >= lo
    const int lo = live ? R - min(i, p.window) : R;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int off = slot_off<R>(i, ln, s);
      const int j = max(i - R + off, 0);
      const int dq = qi - rows.q(j);
      const int dr = ri - rows.r(j);
      // 0 < dq <= max_qgap and 0 < dr <= max_intron, one compare each
      const bool ok = off >= lo &&
                      static_cast<unsigned>(dq - 1) <
                          static_cast<unsigned>(p.max_qgap) &&
                      static_cast<unsigned>(dr - 1) <
                          static_cast<unsigned>(p.max_intron);
      if (kTable) {
        // a valid pair's dd + max_qgap lies in [1, max_qgap + max_intron)
        tl.cost[t][s] = __ldg(&g_cost[ok ? dr - dq + p.max_qgap
                                         : kCostTable]);
      } else {
        tl.cost[t][s] = ok ? gap_cost(dr - dq, p) : INFINITY;
      }
      tl.gain[t][s] = static_cast<float>(min(min(dq, dr), p.k));
    }
  }
}

// The DP of one read over its n anchors: rows gives each anchor's (q, r)
// (rows.ready(a0) before the lookahead reads anchors a0 .. a0 + T - 1 and
// their window), out.step(i, f, parent) takes each step's result in every
// lane and out.flush(e) follows the tile of steps that ends before e.
//
// A step's dependent path is the S scores, the lane's max, one redux of
// its order key and the select of f[i] into the owner's ring slot: with
// k > 0, a max above k is a positive float whose key is its own bits.  The
// parent (the first slot holding the max, one more redux) is off that
// path.
template <int S, bool kTable, class Rows, class Out>
__device__ __forceinline__ void dp_steps(int n, int ln, const ChainArgs& p,
                                         Rows& rows, Out& out) {
  constexpr int R = 32 * S;
  constexpr int T = kTilePairs / S > 0 ? kTilePairs / S : 1;
  const float fk = static_cast<float>(p.k);
  const int key_k = order_key(fk);
  float ring[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ring[s] = 0.0f;
  Tile<T, S> cur, nxt;
  rows.ready(0);
  precompute<T, S, R, kTable>(cur, 0, ln, n, rows, p);
  for (int i0 = 0; i0 < n; i0 += T) {
    rows.ready(i0 + T);
    precompute<T, S, R, kTable>(nxt, i0 + T, ln, n, rows, p);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = i0 + t;
      float sc[S];
      float lane_max = -INFINITY;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        sc[s] = __fsub_rn(__fadd_rn(ring[s], cur.gain[t][s]), cur.cost[t][s]);
        lane_max = fmaxf(lane_max, sc[s]);
      }
      const int best = __reduce_max_sync(kFull, order_key(lane_max));
      const bool take = best > key_k;
      const float fi = take ? __int_as_float(best) : fk;
      // slot i mod R: lane i mod 32, register (i mod R) / 32
      const unsigned hit = ln == (i & 31) ? 1u << ((i & (R - 1)) >> 5) : 0u;
#pragma unroll
      for (int s = 0; s < S; ++s) ring[s] = (hit >> s) & 1u ? fi : ring[s];
      const float bv = __int_as_float(order_key(__int_as_float(best)));
      int bj = INT_MAX;
#pragma unroll
      for (int s = 0; s < S; ++s)
        bj = sc[s] == bv ? min(bj, i - R + slot_off<R>(i, ln, s)) : bj;
      bj = __reduce_min_sync(kFull, bj);
      out.step(i, fi, take ? bj : -1);
    }
    cur = nxt;
    out.flush(i0 + T);
  }
}

// ------------------------------------------------- fused DP + backtrack

// A predecessor's (q, r) from the read's whole row in shared memory.
struct StagedRows {
  const int32_t* qs;
  const int32_t* rs;
  __device__ __forceinline__ void ready(int) const {}
  __device__ __forceinline__ int q(int a) const { return qs[a]; }
  __device__ __forceinline__ int r(int a) const { return rs[a]; }
};

// f / parent of each step into the read's shared arrays.
struct StagedOut {
  float* f;
  int32_t* par;
  int n, ln;
  __device__ __forceinline__ void step(int i, float fi, int pi) {
    if (ln == 0 && i < n) {
      f[i] = fi;
      par[i] = pi;
    }
  }
  __device__ __forceinline__ void flush(int) const {}
};

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
  StagedRows rows{q, r};
  StagedOut out{f, par, n, ln};
  dp_steps<S, kTable>(n, ln, p, rows, out);
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

// ----------------------------------------------------------- DP alone

// Anchors of the circular buffer of a ring of R slots: the window behind
// the lookahead, the chunk it reads and the chunk in flight.
template <int R>
__host__ __device__ constexpr int stream_slots() {
  return R + 64 <= 128 ? 128 : R + 64 <= 512 ? 512 : R + 64 <= 1024 ? 1024
                                                                    : 2048;
}

// Reads (warps) a block of the DP alone: the buffers stay in 48 KB of
// static shared memory.
template <int S>
__host__ __device__ constexpr int dp_warps() {
  return 4 * 8 * stream_slots<32 * S>() <= kSmemCap ? 4 : 2;
}

// A predecessor's (q, r) from a per-warp circular buffer of Q anchors,
// filled by cp.async 32 anchors (one chunk) at a time.
template <int Q>
struct StreamRows {
  int32_t* qs;
  int32_t* rs;
  const int32_t* gq;                    // the read's row in device memory
  const int32_t* gr;
  int n, ln;
  __device__ __forceinline__ void issue(int c) {
    const int a = c * 32 + ln;
    if (a < n) {
      __pipeline_memcpy_async(&qs[a & (Q - 1)], &gq[a], 4);
      __pipeline_memcpy_async(&rs[a & (Q - 1)], &gr[a], 4);
    }
    __pipeline_commit();
  }
  // Before the lookahead enters chunk c = a0 / 32: wait for chunk c, then
  // send chunk c + 1 into the slots of anchors at least R + 1 behind a0.
  __device__ __forceinline__ void ready(int a0) {
    if ((a0 & 31) == 0) {
      __pipeline_wait_prior(0);
      __syncwarp();
      issue((a0 >> 5) + 1);
    }
  }
  __device__ __forceinline__ int q(int a) const { return qs[a & (Q - 1)]; }
  __device__ __forceinline__ int r(int a) const { return rs[a & (Q - 1)]; }
};

// f / parent of step i kept by lane i mod 32, each chunk of 32 steps
// stored in one coalesced store per array once its last tile is done.
struct ChunkOut {
  float* f;                             // the read's row in device memory
  int32_t* par;
  int n, ln;
  float fo = kNeg;
  int po = -1;
  __device__ __forceinline__ void step(int i, float fi, int pi) {
    fo = ln == (i & 31) ? fi : fo;
    po = ln == (i & 31) ? pi : po;
  }
  // e: the end of a tile; tiles never straddle a chunk
  __device__ __forceinline__ void flush(int e) {
    if ((e & 31) == 0 || e >= n) {
      const int a = ((e - 1) & ~31) + ln;
      if (a < n) {
        f[a] = fo;
        par[a] = po;
      }
    }
  }
};

template <int S, bool kTable>
__global__ void __launch_bounds__(dp_warps<S>() * 32)
chain_dp_kernel(const int32_t* __restrict__ qpos,
                const int32_t* __restrict__ rpos,
                const int32_t* __restrict__ n_anchor, int B, int A,
                ChainArgs p, float* __restrict__ f_out,
                int32_t* __restrict__ parent_out) {
  constexpr int kWarps = dp_warps<S>();
  constexpr int Q = stream_slots<32 * S>();
  __shared__ int32_t buf[kWarps][2][Q];
  const int ln = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;                   // warp-uniform
  const int n = min(max(n_anchor[b], 0), A);
  const size_t row = static_cast<size_t>(b) * A;
  StreamRows<Q> rows{buf[warp][0], buf[warp][1], qpos + row, rpos + row, n,
                     ln};
  ChunkOut out{f_out + row, parent_out + row, n, ln};
  rows.issue(0);
  dp_steps<S, kTable>(n, ln, p, rows, out);
  __pipeline_wait_prior(0);             // no copy outlives the warp
  for (int a = n + ln; a < A; a += 32) {
    f_out[row + a] = kNeg;
    parent_out[row + a] = -1;
  }
}

// ------------------------------------------------------------- launch

// Reads (warps) per block of the fused kernel: up to kBlockThreads / 32,
// under kSmemCap of shared memory; 0 when one read does not fit.
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
  // at least one block: it also writes the +inf entry
  fill_cost_table<<<size / 256 + 1, 256, 0, stream>>>(p, size);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  h = Held{true, p.max_qgap, p.max_intron, p.min_intron_gap,
           p.gap_open, p.gap_scale, p.intron_scale};
  return static_cast<int>(cudaSuccess);
}

// go(std::true_type) launches the kernel that reads the cost table, under
// g_cost_mu with the table filled for p; go(std::false_type) the one that
// computes each cost inline, when p's dd range exceeds the table.
template <class Go>
int with_cost_table(const ChainArgs& p, cudaStream_t stream, Go&& go) {
  if (p.max_qgap >= 0 && p.max_intron >= 0 &&
      static_cast<long long>(p.max_qgap) + p.max_intron <= kCostTable) {
    std::lock_guard<std::mutex> hold(g_cost_mu);
    const int rc = ensure_cost_table(p, stream);
    if (rc != 0) return rc;
    go(std::true_type{});
    return static_cast<int>(cudaGetLastError());
  }
  go(std::false_type{});
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_fused(const int32_t* qpos, const int32_t* rpos,
                 const int32_t* n_anchor, int B, int A, const ChainArgs& p,
                 uint8_t* mask, float* ps, float* ss, float* f_out,
                 int32_t* parent_out, cudaStream_t stream) {
  const int rpb = reads_per_block(A);
  if (rpb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(rpb) * read_stride_bytes(A);
  return with_cost_table(p, stream, [&](auto table) {
    chain_dp_backtrack_kernel<S, decltype(table)::value>
        <<<blocks, rpb * 32, smem, stream>>>(qpos, rpos, n_anchor, B, A, p,
                                             mask, ps, ss, f_out,
                                             parent_out);
  });
}

template <int S>
int launch_dp(const int32_t* qpos, const int32_t* rpos,
              const int32_t* n_anchor, int B, int A, const ChainArgs& p,
              float* f_out, int32_t* parent_out, cudaStream_t stream) {
  constexpr int kWarps = dp_warps<S>();
  const int blocks = (B + kWarps - 1) / kWarps;
  return with_cost_table(p, stream, [&](auto table) {
    chain_dp_kernel<S, decltype(table)::value>
        <<<blocks, kWarps * 32, 0, stream>>>(qpos, rpos, n_anchor, B, A, p,
                                             f_out, parent_out);
  });
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
    return launch_fused<2>(qp, rp, np_, B, A, p, mk, psp, ssp, fo, po, st);
  if (window <= 256)
    return launch_fused<8>(qp, rp, np_, B, A, p, mk, psp, ssp, fo, po, st);
  return launch_fused<16>(qp, rp, np_, B, A, p, mk, psp, ssp, fo, po, st);
}

// qpos, rpos, f_out, parent_out: [B, A] row-major; n_anchor: [B].  Any A;
// refuses a window over 1024, whatever A is; a window of A or more is
// taken as A.  Returns cudaGetLastError().
int lr2_chain_dp(const void* qpos, const void* rpos, const void* n_anchor,
                 int B, int A, int window, int k, int max_qgap,
                 int max_intron, int min_intron_gap, float gap_open,
                 float gap_scale, float intron_scale, void* f_out,
                 void* parent_out, void* stream) {
  if (B < 0 || A <= 0 || window <= 0 || window > kMaxWindow ||
      f_out == nullptr || parent_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  window = window < A ? window : A;
  const ChainArgs p{window, k, max_qgap, max_intron, min_intron_gap,
                    gap_open, gap_scale, intron_scale, 0.0f};
  const auto* qp = static_cast<const int32_t*>(qpos);
  const auto* rp = static_cast<const int32_t*>(rpos);
  const auto* np_ = static_cast<const int32_t*>(n_anchor);
  auto* fo = static_cast<float*>(f_out);
  auto* po = static_cast<int32_t*>(parent_out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (window <= 64)
    return launch_dp<2>(qp, rp, np_, B, A, p, fo, po, st);
  if (window <= 256)
    return launch_dp<8>(qp, rp, np_, B, A, p, fo, po, st);
  if (window <= 512)
    return launch_dp<16>(qp, rp, np_, B, A, p, fo, po, st);
  return launch_dp<32>(qp, rp, np_, B, A, p, fo, po, st);
}

const char* lr2_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
