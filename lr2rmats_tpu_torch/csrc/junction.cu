// Junction placement: both flank shift DPs and the combine, one warp a gap.
//
// Replaces lr2rmats_tpu/ops/splice_device.py:_junction_scan (:260), one
// jax.jit of the flank DP twice (_shift_dp_scan :215, Pallas twin
// _dp_kernel :295) and the combine (_combine :152, XLA), which the
// reference's junction backends run per batch of gaps.  Plain PyTorch
// version: ops/junction.py junction_place_reference (shift_dp_reference
// twice, then combine_reference).
//
// What it computes, per gap g with m = m[g], W = 2B+1, B = 4:
//   SL = shift DP of (q, lwin), SR = shift DP of (qr, rwin), each
//   [M+1, W] (ops/splice.py shift_dp_reference);
//   v(j, cl, cr) = SL[j,cl] + SR[clip(m-j,0,M),cr] + bonus(dok[j+cl], aok[a])
//                  - 0.375 max(el-(j+cl-B), 0) - 0.375 max(er-(m-j+cr-B), 0),
//   a = clip(m-j+cr, 0, M+2B); v = NEG where j > m, a class < 0, or
//   span-m+2B-(cl+cr) < min_intron;
//   out: the largest flat index (j*W + cl)*W + cr among the maxima of v
//   (splice_device.py:195-203), its score, j, cl, cr, the vote of its
//   classes, found = score > NEG/2.
//
// Which rows a flank needs: the combine reads SL rows j <= m and SR rows
// clip(m-j, 0, M) <= min(m, M) only (ops/junction.py _combine_chunk: the
// gate jj <= m and the gather idx = clip(m - jj, 0, M)); cells j > m are
// NEG whatever S holds.  So each flank runs rows 0..R, R = min(m, M), and
// the cells j > m enter only through the tie rule: when no cell j <= m
// beats NEG and m < M, the answer is the last cell (M, W-1, W-1) at NEG.
//
// What bounded the three launches it replaces (csrc/shift_dp.cu twice,
// then csrc/combine.cu): SL and SR, 9.34 MB each at G = 3485, written to
// HBM by two launches and read back by a third.  Here S never leaves the
// SM.  What bounds this kernel: the flank DP's dependent rows.  Design,
// for Hopper:
//   - A block is 8 gaps and 8 warps.  Warp 0 runs both flank DPs of all
//     8 gaps, a thread per flank (lane gi the left flank of gap gi, lane
//     8 + gi its right flank), all W shifts of a row in registers and the
//     deletion scan sequential over them, as the plain version's.  A row
//     is ~100 instructions with one dependent chain through it, so it is
//     latency-bound in its warp (measured ~360-400 cycles a row on the
//     H100, also alone on its SM): the lane layout of csrc/shift_dp.cu (a
//     lane per shift, the scan as a max-plus prefix over lanes) took
//     ~2.2x longer here, and a register prefix scan (log depth, more
//     instructions) ~2.2x longer too.  The code columns come from device
//     memory, each load kAhead rows ahead of its row, so the DP starts at
//     once instead of after a block-wide staging pass (~9K cycles).
//   - Meanwhile warps 1-7 stage the keyed donor / acceptor classes and
//     build the acceptor key of every (j, cr) cell.
//   - Each DP row goes straight into hoisted per-gap tables in shared
//     memory: left term Lt[j][cl] = SL[j][cl] - pen_l(j+cl), right term
//     Rt[j][cr] = SR[clip(m-j)][cr] - pen_r(m-j+cr) (the right flank
//     writes its row r to every tile row j with clip(m-j) = r).  The
//     combine, one warp a gap, then does two adds a cell, a bonus read
//     from a 6 x 8 table of (donor key, acceptor key), and one compare
//     against the gap's intron threshold (the gate depends on cl + cr
//     alone), the gate a select to exactly NEG as in the plain version.
//   - Bit-exactness of the reordered sum.  The plain version computes
//     (((SL + SR) + bonus) - pen_l) - pen_r; this kernel computes
//     ((SL - pen_l) + (SR - pen_r)) + bonus.  Every finite term is a
//     multiple of 1/8: |S| < 2^13 for M <= kMaxM, bonus <= 10, and pen <=
//     0.375 (2^19 + B) < 2^18 while el, er <= kExactCap = 2^19, so every
//     partial sum is below 2^20 and exact in float32 in either order.  A
//     NEG flank (-1e18) absorbs any finite sum (ulp(1e18) = 2^36), so one
//     NEG flank gives NEG and two give -2e18 in either order.  A gap whose
//     el or er exceeds kExactCap keeps raw S in its tables and takes the
//     plain order, each pen computed per cell.
//   - Argmax: in a lane, cells are visited in increasing flat index and
//     `v >= best` keeps the later one; across lanes, two redux
//     instructions: the max of an order-preserving integer key of the
//     score (no cell is -0.0 or NaN), then the max index among the lanes
//     holding it.
//   - ~43 KB of dynamic shared memory a block at M = 64, 4 blocks an SM:
//     every gap of a 3485-gap batch is in flight at once.
// No TF32, no half, no FMA contraction (__fadd_rn / __fsub_rn /
// __fmul_rn): scores stay exact.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;          // splice_device.NEG
constexpr float kHalfNeg = -5e17f;      // NEG / 2, the found threshold
constexpr float kMatch = 1.0f;
constexpr float kMismatch = -2.0f;
constexpr float kGap = -3.0f;
constexpr float kWPos = 0.375f;         // align/splice.py W_POS
constexpr int kB = 4;
constexpr int kW = 2 * kB + 1;
constexpr int kGPB = 8;                 // gaps per block, one warp each
constexpr int kThreads = kGPB * 32;
constexpr int kBonusCols = 8;           // bonus table [6][8]
constexpr int kMaxM = 256;              // |S| < 2^13 (the exactness bound)
constexpr int kExactCap = 1 << 19;      // el, er at or below: hoisted order
constexpr int kSmemCap = 227 * 1024;
constexpr int kBatch = 8;               // staging loads in flight a thread
constexpr int kAhead = 4;               // DP rows a code load runs ahead

// class -> key: 0 for a class < 0 (the cell is gated), 1 for none (0 or
// >= 5), 2..5 for classes 1..4
__device__ __forceinline__ int class_key(int cls) {
  return cls < 0 ? 0 : (cls >= 1 && cls <= 4 ? cls + 1 : 1);
}

// motif bonus and vote of donor / acceptor classes (ops/junction.py
// _motif_terms); classes outside 1..4 match nothing
__device__ __forceinline__ void motif(int dc, int ac, float* bonus,
                                      int* vote) {
  const bool canon_p = dc == 1 && ac == 1;
  const bool canon_m = dc == 2 && ac == 2;
  const bool semi_p = (dc == 3 && ac == 1) || (dc == 4 && ac == 2);
  const bool semi_m = (dc == 2 && ac == 3) || (dc == 1 && ac == 4);
  *bonus = (canon_p || canon_m) ? 10.0f : ((semi_p || semi_m) ? 8.0f : 0.0f);
  *vote = ((canon_p || semi_p) ? 1 : 0) - ((canon_m || semi_m) ? 1 : 0);
}

// 0.375 max(e - (off - B), 0), rounded as the plain version's
// float32(int64) * 0.375
__device__ __forceinline__ float hinge(int e, long long off) {
  const long long d = static_cast<long long>(e) - (off - kB);
  return __fmul_rn(kWPos, static_cast<float>(d > 0 ? d : 0));
}

// order-preserving integer key of a float that is neither NaN nor -0.0
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Shared memory of a block, in bytes from its start: float tiles Lt, Rt
// [GPB][T]; the bonus table [6][8]; R per gap; acceptor keys [GPB][T];
// keyed donor / acceptor columns [GPB][K].
struct Layout {
  int T, K;
  size_t rt, btab, rows, akey, dkc, akc, bytes;

  __host__ __device__ explicit Layout(int M)
      : T((M + 1) * kW), K(M + 2 * kB + 1) {
    rt = static_cast<size_t>(kGPB) * T * 4;
    btab = rt + static_cast<size_t>(kGPB) * T * 4;
    rows = btab + 6 * kBonusCols * 4;
    akey = rows + kGPB * 4;
    dkc = akey + static_cast<size_t>(kGPB) * T;
    akc = dkc + static_cast<size_t>(kGPB) * K;
    bytes = akc + static_cast<size_t>(kGPB) * K;
  }
};

// The combine over rows 0..R of one gap; kHoist: tables hold the hoisted
// terms, else raw S and the pens are computed per cell (plain order).
template <bool kHoist>
__device__ __forceinline__ void combine_rows(
    const float* __restrict__ Lt, const float* __restrict__ Rt,
    const uint8_t* __restrict__ akey, const uint8_t* __restrict__ dkc,
    const float* __restrict__ btab, int R, int m, int el, int er, int thr,
    int lane, float* best, int* bf) {
  const int P = (R + 1) * kW;             // (j, cl) pairs
  for (int p = lane; p < P; p += 32) {    // increasing flat index
    const int j = p / kW, cl = p - j * kW;
    const float lt = Lt[p];
    const int dk = dkc[j + cl];
    const int tcl = dk != 0 ? thr - cl : -1;
    const float* bt = btab + dk * kBonusCols;
    const float* rrow = Rt + j * kW;
    const uint8_t* arow = akey + j * kW;
    float pl = 0.0f;
    if (!kHoist) pl = hinge(el, j + cl);
#pragma unroll
    for (int cr = 0; cr < kW; ++cr) {
      const int ak = arow[cr];
      float v = __fadd_rn(lt, rrow[cr]);
      v = __fadd_rn(v, bt[ak]);
      if (!kHoist)
        v = __fsub_rn(__fsub_rn(v, pl),
                      hinge(er, static_cast<long long>(m) - j + cr));
      v = (ak != 0 && cr <= tcl) ? v : kNeg;
      if (v >= *best) {                   // later cells win ties
        *best = v;
        *bf = p * kW + cr;
      }
    }
  }
}

// One DP row of a flank, all W shifts in registers: s holds row j-1 and
// becomes row j; w[c] is the window code of row j+c-B-1, qj the query
// code of row j-1.  The deletion scan runs over c in order, as the plain
// version's.  kEdge: j <= B, where the cells with j+c-B < 1 have no
// diagonal and those with j+c-B < 0 are NEG (later rows need neither
// mask, and no row j <= min(m, M) reaches j+c-B > m+B).
template <bool kEdge>
__device__ __forceinline__ void dp_row(float (&s)[kW], const int32_t (&w)[kW],
                                       int32_t qj, int j) {
  float v[kW];
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    float diag = __fadd_rn(s[c], w[c] == qj ? kMatch : kMismatch);
    if (kEdge && j + c - kB < 1) diag = kNeg;
    const float ins = c + 1 < kW ? __fadd_rn(s[c + 1], kGap) : kNeg;
    v[c] = fmaxf(diag, ins);
  }
  float best = kNeg;
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    best = fmaxf(__fadd_rn(best, kGap), v[c]);
    if (kEdge && j + c - kB < 0) best = kNeg;
    s[c] = best;
  }
}

// Rows 0..R of one flank's DP, each row written as it is made into the
// gap's table: the left flank's row r at tile row r, the right flank's at
// tile row m - r (and, when m > M, its row M at every tile row j <= m -
// M).  With hoist each value is stored less its hinge, pen(e, r + c) =
// max(0.375 (e + B - r) - 0.375 c, 0), which is 0.375 max(e - (r + c -
// B), 0) exactly; else raw.  The query codes (qg[r G], rows < R) and the
// window codes (wg[r G], rows < R + B) come from device memory, each
// loaded kAhead rows before the row that uses it: the loop is unrolled by
// kAhead so that each load lands in the register its row frees.
__device__ __forceinline__ void flank_dp(const int32_t* __restrict__ qg,
                                         const int32_t* __restrict__ wg,
                                         size_t Gs, float* __restrict__ tbl,
                                         int R, int M, int m, int e,
                                         bool hoist, bool right) {
  auto ldq = [&](int r) { return r < R ? qg[r * Gs] : 0; };
  auto ldw = [&](int r) { return r < R + kB ? wg[r * Gs] : 0; };
  int32_t qa[kAhead], wa[kAhead];       // for row j0 + k: q row j0 + k - 1,
#pragma unroll                          // window row j0 + k + B
  for (int k = 0; k < kAhead; ++k) {
    qa[k] = ldq(k);
    wa[k] = ldw(k + 1 + kB);
  }
  int32_t w[kW];                        // rows j+c-B-1 of the window
#pragma unroll
  for (int c = 0; c < kW; ++c) w[c] = c >= kB ? ldw(c - kB) : 0;
  // e + B, clamped below where every hinge is 0 (hoist: e <= kExactCap)
  const int ke = hoist ? max(e, -(1 << 20)) + kB : -(1 << 22);
  float s[kW];
#pragma unroll
  for (int c = 0; c < kW; ++c)
    s[c] = c >= kB ? kGap * static_cast<float>(c - kB) : kNeg;
  auto put = [&](int r) {
    const int jt = right ? m - r : r;
    if (jt <= R) {
      float* row = tbl + jt * kW;
      if (ke - r > 0) {                 // some shift still has a hinge
        const float a = __fmul_rn(kWPos, static_cast<float>(ke - r));
#pragma unroll
        for (int c = 0; c < kW; ++c)
          row[c] = __fsub_rn(s[c], fmaxf(__fsub_rn(a, kWPos * c), 0.0f));
      } else {
#pragma unroll
        for (int c = 0; c < kW; ++c) row[c] = s[c];
      }
    }
    if (right && r == M && m > M) {
      const int jhi = min(m - M, M);
      for (int j = 0; j <= jhi; ++j) {
#pragma unroll
        for (int c = 0; c < kW; ++c)
          tbl[j * kW + c] =
              hoist ? __fsub_rn(s[c], hinge(e, static_cast<long long>(m) - j +
                                                   c))
                    : s[c];
      }
    }
  };
  put(0);
  auto rows = [&](int j0, auto edge) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int j = j0 + k;
      if (j <= R) {
        const int32_t qj = qa[k], wn = wa[k];
        qa[k] = ldq(j - 1 + kAhead);
        wa[k] = ldw(j + kAhead + kB);
        dp_row<decltype(edge)::value>(s, w, qj, j);
        put(j);
#pragma unroll
        for (int c = 0; c + 1 < kW; ++c) w[c] = w[c + 1];
        w[kW - 1] = wn;
      }
    }
  };
  static_assert(kAhead == kB, "the first kAhead rows are the edge rows");
  if (R > 0) rows(1, std::true_type());
  for (int j0 = 1 + kAhead; j0 <= R; j0 += kAhead)
    rows(j0, std::false_type());
}

__global__ void __launch_bounds__(kThreads, 4)
junction_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ qr,
                const int32_t* __restrict__ lwin,
                const int32_t* __restrict__ rwin,
                const int32_t* __restrict__ mg_, const int64_t* __restrict__ span,
                const int8_t* __restrict__ dok, const int8_t* __restrict__ aok,
                const int32_t* __restrict__ el_, const int32_t* __restrict__ er_,
                int M, int G, long long min_intron, float* __restrict__ score,
                int32_t* __restrict__ bj, int32_t* __restrict__ bcl,
                int32_t* __restrict__ bcr, int32_t* __restrict__ vote,
                uint8_t* __restrict__ found) {
  const Layout L(M);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Lt_all = reinterpret_cast<float*>(smem);
  float* Rt_all = reinterpret_cast<float*>(smem + L.rt);
  float* btab = reinterpret_cast<float*>(smem + L.btab);
  int* rows_s = reinterpret_cast<int*>(smem + L.rows);
  uint8_t* akey_all = smem + L.akey;
  uint8_t* dkc_all = smem + L.dkc;
  uint8_t* akc_all = smem + L.akc;

  const int g0 = blockIdx.x * kGPB;
  const size_t Gs = static_cast<size_t>(G);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp == 0) {
    // --- both flank DPs, straight from device memory: lane gi the left
    // flank of gap gi, lane kGPB + gi its right flank --------------------
    const int gi = lane % kGPB, g = g0 + gi;
    const bool right = lane >= kGPB;
    const int mg = lane < 2 * kGPB && g < G ? mg_[g] : -1;
    if (mg >= 0) {
      const bool hoist = el_[g] <= kExactCap && er_[g] <= kExactCap;
      flank_dp((right ? qr : q) + g, (right ? rwin : lwin) + g, Gs,
               (right ? Rt_all : Lt_all) + gi * L.T, min(mg, M), M, mg,
               right ? er_[g] : el_[g], hoist, right);
    }
  } else {
    // --- meanwhile the other warps: the bonus table, R per gap, the
    // keyed donor / acceptor classes (all rows, kBatch loads in flight a
    // thread before their stores), then the acceptor key of every (j, cr)
    // a combine reads: row jt of gap gi holds akc[clip(m - jt + cr, 0,
    // M + 2B)] --------------------------------------------------------
    const int t = tid - 32, nt = kThreads - 32;
    if (t < 6 * kBonusCols) {
      const int dk = t / kBonusCols, ak = t % kBonusCols;
      float b = 0.0f;
      int vt;
      if (dk >= 2 && ak >= 2 && ak <= 5) motif(dk - 1, ak - 1, &b, &vt);
      btab[t] = b;
    }
    if (t < kGPB) {
      const int g = g0 + t;
      const int mg = g < G ? mg_[g] : -1;
      rows_s[t] = mg < 0 ? -1 : min(mg, M);                // R of the gap
    }
    for (int e0 = t; e0 < 2 * L.K * kGPB; e0 += kBatch * nt) {
      int8_t v[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * nt;
        const int side = e >= L.K * kGPB;
        const int a = e - side * L.K * kGPB;
        const int row = a / kGPB, gi = a % kGPB, g = g0 + gi;
        dst[k] = e < 2 * L.K * kGPB && g < G ? side * kGPB * L.K +
                                                   gi * L.K + row
                                             : -1;
        v[k] = dst[k] >= 0 ? (side ? aok : dok)[row * Gs + g] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (dst[k] >= 0) dkc_all[dst[k]] = static_cast<uint8_t>(
                             class_key(v[k]));
    }
    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");   // warps 1..
    for (int x = t; x < kGPB * (M + 1); x += nt) {
      const int gi = x / (M + 1), jt = x - gi * (M + 1);
      if (jt <= rows_s[gi]) {
        const uint8_t* col = akc_all + gi * L.K;
        uint8_t* row = akey_all + gi * L.T + jt * kW;
        const long long a = static_cast<long long>(mg_[g0 + gi]) - jt;
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          const long long i = a + c;
          row[c] = col[i < 0 ? 0 : (i > L.K - 1 ? L.K - 1 : i)];
        }
      }
    }
  }
  __syncthreads();

  const int g = g0 + warp;
  if (g >= G) return;
  const int mg = mg_[g];
  const int R = rows_s[warp];
  const int elg = el_[g], erg = er_[g];
  const bool hoist = elg <= kExactCap && erg <= kExactCap;
  float* Lt = Lt_all + warp * L.T;
  float* Rt = Rt_all + warp * L.T;
  const uint8_t* akey = akey_all + warp * L.T;
  const uint8_t* dkc = dkc_all + warp * L.K;
  const uint8_t* akc = akc_all + warp * L.K;

  // --- combine ---------------------------------------------------------
  long long thr64 = span[g] - mg + 2 * kB - min_intron;    // cl + cr <= thr
  const int thr = static_cast<int>(thr64 < -1 ? -1
                                   : (thr64 > 2 * kW ? 2 * kW : thr64));
  float best = -INFINITY;
  int bf = -1;
  if (hoist)
    combine_rows<true>(Lt, Rt, akey, dkc, btab, R, mg, elg, erg, thr, lane,
                       &best, &bf);
  else
    combine_rows<false>(Lt, Rt, akey, dkc, btab, R, mg, elg, erg, thr, lane,
                        &best, &bf);
  const int kmax = __reduce_max_sync(kFull, order_key(best));
  bf = __reduce_max_sync(kFull, order_key(best) == kmax ? bf : -1);
  if (lane == 0) {
    best = __int_as_float(kmax >= 0 ? kmax : kmax ^ 0x7fffffff);
    if (R < M && best <= kNeg) {
      // no cell j <= m beats NEG: the cells j > m (all NEG) win the tie
      best = kNeg;
      bf = (M * kW + kW - 1) * kW + kW - 1;
    }
    const int j = bf / (kW * kW);
    const int cl = (bf / kW) % kW;
    const int cr = bf % kW;
    const long long a = static_cast<long long>(mg) - j + cr;
    const int dk = dkc[j + cl];
    const int ak = akc[a < 0 ? 0 : (a > L.K - 1 ? L.K - 1 : a)];
    float b;
    int vt;
    motif(dk >= 2 ? dk - 1 : 0, ak >= 2 ? ak - 1 : 0, &b, &vt);
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

// q, qr: [M, G] int32; lwin, rwin: [M+B, G] int32; m, el, er: [G] int32;
// span: [G] int64; dok, aok: [M+2B+1, G] int8.  Out: score [G] float32;
// bj, bcl, bcr, vote [G] int32; found [G] uint8 (bool).  B must be 4 and
// M at most 256 (kMaxM) with the block's tables within 227 KB of shared
// memory.  Returns cudaGetLastError().
int lr2_junction(const void* q, const void* qr, const void* lwin,
                 const void* rwin, const void* m, const void* span,
                 const void* dok, const void* aok, const void* el,
                 const void* er, int M, int G, int B, long long min_intron,
                 void* score, void* bj, void* bcl, void* bcr, void* vote,
                 void* found, void* stream) {
  if (M < 0 || M > kMaxM || G < 0 || B != kB)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = Layout(M).bytes;
  if (smem > static_cast<size_t>(kSmemCap))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      junction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (G + kGPB - 1) / kGPB;
  junction_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(qr),
      static_cast<const int32_t*>(lwin), static_cast<const int32_t*>(rwin),
      static_cast<const int32_t*>(m), static_cast<const int64_t*>(span),
      static_cast<const int8_t*>(dok), static_cast<const int8_t*>(aok),
      static_cast<const int32_t*>(el), static_cast<const int32_t*>(er), M, G,
      min_intron, static_cast<float*>(score), static_cast<int32_t*>(bj),
      static_cast<int32_t*>(bcl), static_cast<int32_t*>(bcr),
      static_cast<int32_t*>(vote), static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
