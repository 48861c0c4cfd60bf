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
//
// polish_trace, in the same file: the polish placement's split and
// traceback over the two S matrices shift_dp_kernel just wrote.
//
// It replaces no TPU kernel.  It replaces the host re-run of the placement
// DP (lr2rmats_tpu/align/polish.py polish_batch's deferred
// _constrained_place: _shift_dp twice in float64, then _traceback_ops),
// which the polish accept loop ran for every placement the card had
// scored.  Plain PyTorch version: ops/splice.py polish_trace_reference.
//
// What it computes, per gap g (m = m[g], DL = dl[g], DR = dr[g], band 8):
//   the split: over j = 0..m with cl = DL+B-j, cr = DR+B-(m-j) inside
//     [0, W), the largest SL[j, cl] + SR[m-j, cr] above NEG/2, ties to the
//     last maximal j (polish.py _finish_place's `sc >= best`);
//   the two tracebacks: the left flank over SL from (bj, cl) and the right
//     flank over SR, on the reversed query and window, from (m-bj, cr),
//     each step in _traceback_ops's order: diagonal if S[j-1,c] + d ==
//     S[j,c], else deletion if S[j,c-1] - 3 == S[j,c], else insertion if
//     S[j-1,c+1] - 3 == S[j,c].  Every finite score is a small integer,
//     exact in float32, so == is the host's abs(...) < 1e-9;
//   match and NM over both flanks (sums, so the reversed right flank gives
//     the host's totals).
// Out: one row of K = 6 + 2R int32 words per gap, R = 2M + B, the most
// steps a walk can take (#diag + #ins = j <= M, #del = #ins + c - B <=
// M + B): score (float bits; NEG where no split fits), bj (-1 there),
// match, nm, the left and right run counts, then each flank's runs,
// BAM-coded (len << 4 | op, M=0 I=1 D=2) in the host's order, zero past
// the count.  A flank whose walk reaches no predecessor (the host's
// fallback, which a finite cell never takes) gets the count -1, zero
// runs, and zero match and nm: a fault, which the caller raises on.
//
// What bounds it: about m + 2B dependent reads a walk from L2, where the
// S matrices still sit (2 x 193 x 17 x G floats, ~34 MB at G = 1280, of
// the 50 MB L2), and the S reads of the split; the output is 4K bytes a
// gap, of which a walk writes its runs alone.  Design:
//   - one warp per gap; its lanes stride over the splits j, a shuffle
//     reduction picks (score, j) with ties to the larger j;
//   - lane 0 walks the left flank while lane 1 walks the right one; each
//     step issues its three S reads and two code reads together, so a
//     step costs one L2 round trip; the runs go to shared memory;
//   - the warp then writes the gap's row with consecutive lanes on
//     consecutive words.

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

constexpr int kTraceWarps = 4;          // gaps a block of polish_trace
constexpr int kTraceHead = 6;           // score, bj, match, nm, nl, nr
constexpr int kOpM = 0, kOpI = 1, kOpD = 2;

struct Walk {
  int n;        // runs, or -1 where the walk failed
  int match;
  int nm;
};

// One flank's traceback from (j, c) over S [M+1, W, G] (gap g, stride G),
// pushing BAM-coded runs in walk order into buf[0, R).  R = 2M + B holds
// every walk; the count check only keeps a fault inside the buffer.
template <int B>
__device__ Walk trace_flank(const float* __restrict__ S,
                            const int8_t* __restrict__ q,
                            const int8_t* __restrict__ w, size_t Gs, int g,
                            int j, int c, uint32_t* buf, int R) {
  constexpr int W = 2 * B + 1;
  Walk out{0, 0, 0};
  int last = -1;
  uint32_t run = 0;
  float cur = S[(static_cast<size_t>(j) * W + c) * Gs + g];
  while (j > 0 || c != B) {
    const int rlen = j + c - B;
    const bool has_diag = j > 0 && rlen >= 1;
    const bool has_del = c > 0;
    const bool has_ins = j > 0 && c + 1 < W;
    // the step's reads, all issued before any is used
    const size_t up = (static_cast<size_t>(j > 0 ? j - 1 : 0) * W + c) * Gs + g;
    const float s_diag = j > 0 ? S[up] : kNeg;
    const float s_del =
        has_del ? S[(static_cast<size_t>(j) * W + c - 1) * Gs + g] : kNeg;
    const float s_ins = has_ins ? S[up + Gs] : kNeg;
    const int8_t qc = has_diag ? q[static_cast<size_t>(j - 1) * Gs + g] : 0;
    const int8_t wc = has_diag ? w[static_cast<size_t>(rlen - 1) * Gs + g] : 0;
    const bool eq = qc == wc;
    int op;
    if (has_diag && __fadd_rn(s_diag, eq ? kMatch : kMismatch) == cur) {
      op = kOpM;
      cur = s_diag;
      --j;
      if (eq) ++out.match; else ++out.nm;
    } else if (has_del && __fadd_rn(s_del, kGap) == cur) {
      op = kOpD;
      cur = s_del;
      --c;
      ++out.nm;
    } else if (has_ins && __fadd_rn(s_ins, kGap) == cur) {
      op = kOpI;
      cur = s_ins;
      --j;
      ++c;
      ++out.nm;
    } else {
      return Walk{-1, 0, 0};            // the host's fallback: not taken here
    }
    if (op == last) {
      ++run;
    } else {
      if (last >= 0) {
        if (out.n >= R) return Walk{-1, 0, 0};
        buf[out.n++] = run << 4 | static_cast<uint32_t>(last);
      }
      last = op;
      run = 1;
    }
  }
  if (last >= 0) {
    if (out.n >= R) return Walk{-1, 0, 0};
    buf[out.n++] = run << 4 | static_cast<uint32_t>(last);
  }
  return out;
}

template <int B>
__global__ void __launch_bounds__(kTraceWarps * 32)
polish_trace_kernel(const float* __restrict__ SL, const float* __restrict__ SR,
                    const int8_t* __restrict__ q, const int8_t* __restrict__ qr,
                    const int8_t* __restrict__ lwin,
                    const int8_t* __restrict__ rwin,
                    const int32_t* __restrict__ m,
                    const int32_t* __restrict__ dl,
                    const int32_t* __restrict__ dr, int32_t* __restrict__ out,
                    int M, int G) {
  constexpr int W = 2 * B + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kTraceWarps + warp;
  if (g >= G) return;                   // whole warps only: no block barrier
  const int R = 2 * M + B;
  const int K = kTraceHead + 2 * R;
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem) + warp * 2 * R;
  const size_t Gs = static_cast<size_t>(G);
  const int mg = m[g], DL = dl[g], DR = dr[g];

  // the split: the largest sum, ties to the last j
  float best = kNeg;
  int bj = -1;
  if (mg >= 0 && mg <= M) {
    for (int j = lane; j <= mg; j += 32) {
      const int cl = DL + B - j, cr = DR + B - (mg - j);
      if (cl < 0 || cl >= W || cr < 0 || cr >= W) continue;
      const float sc =
          __fadd_rn(SL[(static_cast<size_t>(j) * W + cl) * Gs + g],
                    SR[(static_cast<size_t>(mg - j) * W + cr) * Gs + g]);
      if (sc > 0.5f * kNeg && sc >= best) {
        best = sc;
        bj = j;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oj = __shfl_xor_sync(kFull, bj, off);
    if (ob > best || (ob == best && oj > bj)) {
      best = ob;
      bj = oj;
    }
  }

  // the two tracebacks, lane 0 left and lane 1 right
  Walk walk{0, 0, 0};
  if (bj >= 0 && lane < 2) {
    if (lane == 0)
      walk = trace_flank<B>(SL, q, lwin, Gs, g, bj, DL + B - bj, bufs, R);
    else
      walk = trace_flank<B>(SR, qr, rwin, Gs, g, mg - bj,
                            DR + B - (mg - bj), bufs + R, R);
  }
  const int nl = __shfl_sync(kFull, walk.n, 0);
  const int nr = __shfl_sync(kFull, walk.n, 1);
  const bool ok = nl >= 0 && nr >= 0;
  const int match = ok ? __shfl_sync(kFull, walk.match, 0) +
                             __shfl_sync(kFull, walk.match, 1) : 0;
  const int nm = ok ? __shfl_sync(kFull, walk.nm, 0) +
                          __shfl_sync(kFull, walk.nm, 1) : 0;
  __syncwarp();

  // the gap's row: head, left runs reversed (the host's order), right runs
  int32_t* row = out + static_cast<size_t>(g) * K;
  for (int k = lane; k < K; k += 32) {
    int32_t v = 0;
    if (k == 0) {
      v = __float_as_int(best);
    } else if (k == 1) {
      v = bj;
    } else if (k == 2) {
      v = match;
    } else if (k == 3) {
      v = nm;
    } else if (k == 4) {
      v = nl;
    } else if (k == 5) {
      v = nr;
    } else if (k < kTraceHead + R) {
      const int i = k - kTraceHead;
      if (i < nl) v = static_cast<int32_t>(bufs[nl - 1 - i]);
    } else {
      const int i = k - kTraceHead - R;
      if (i < nr) v = static_cast<int32_t>(bufs[R + i]);
    }
    row[k] = v;
  }
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

// SL, SR: [M+1, 17, G] float32 (shift_dp's band-8 output for the left and
// the reversed right flank); q, qr: [M, G] int8; lwin, rwin: [M+8, G] int8;
// m, dl, dr: [G] int32; out: [G, 6 + 2(2M+8)] int32.  band must be 8 (the
// polish band).  Refuses an M whose run buffers exceed 48 KB of shared
// memory.  Returns cudaGetLastError().
int lr2_polish_trace(const void* SL, const void* SR, const void* q,
                     const void* qr, const void* lwin, const void* rwin,
                     const void* m, const void* dl, const void* dr, void* out,
                     int M, int G, int band, void* stream) {
  if (M < 0 || G < 0 || band != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      static_cast<size_t>(kTraceWarps) * 2 * (2 * M + 8) * sizeof(uint32_t);
  if (smem > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (G + kTraceWarps - 1) / kTraceWarps;
  polish_trace_kernel<8><<<blocks, kTraceWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(SL), static_cast<const float*>(SR),
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(qr),
      static_cast<const int8_t*>(lwin), static_cast<const int8_t*>(rwin),
      static_cast<const int32_t*>(m), static_cast<const int32_t*>(dl),
      static_cast<const int32_t*>(dr), static_cast<int32_t*>(out), M, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
