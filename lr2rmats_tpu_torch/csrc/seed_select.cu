// Hit selection of the seeding stage, next to the card-resident index.
//
// Replaces no TPU kernel: the reference expands, sorts and groups the
// lookup's hits on the host (lr2rmats_tpu/align/batch.py _batch_anchors,
// after the lookup), and so does the port's host path.  This kernel does
// that work on the card for the reads of a batch whose hits fit one
// block's shared memory, so that only the kept anchors come back.
// Plain PyTorch version: index/seed_device.py seed_select_reference.
//
// What it computes, per read r (one block), with its queries
// qoff[r] .. qoff[r+1] (the batch's queries are in read order) and its
// hits hoff[r] .. hoff[r+1] (query j's hits are the table entries
// lo[j] .. lo[j] + cs[j] - cs[j-1], cs the inclusive sum of hi - lo):
//   1. expand: each hit's table entry e = pos << 1 | strand gives the
//      anchor (st = qstrand ^ strand, gp = pos, qf = st ? L - k - qp : qp)
//      and its key st << 51 | gp << 19 | qf;
//   2. sort the read's keys ascending (equal keys are equal anchors);
//   3. cut groups where the strand changes, gp steps over max_intron or
//      the chromosome (upper bound in chrom_off) changes;
//   4. keep, for each strand, the top 4 groups of >= 2 anchors by count
//      descending, then group order ascending (the host's stable argsort
//      of its count key: a group of one anchor ranks after every group of
//      two or more, so leaving it out changes no rank);
//   5. subsample each kept group of n anchors to
//      m = min(n, max(a_max, qspan / half_qgap + 2)) anchors, anchor w
//      being start + w * (n - 1) / (m - 1), and describe its row: m, base
//      (the group's first gp), n_big (consecutive kept gp steps >= 2^16)
//      and q_max (the largest kept qf).
// A read with more than `cap` hits is marked kept = -1 and left to the
// host path.  meta[r] = (kept, then for slot s = strand * 4 + rank:
// m, base, n_big, q_max; m = 0 for an empty slot); the kept anchors, as
// gp << 19 | qf, go to out in read order, then slot order.
//
// What bounds it: bytes.  A hit reads one 8-byte table entry at a place
// the index decides (a 32-byte sector each, in effect), and the keys
// never leave shared memory; the work a hit is a few dozen compare-swaps
// of the in-shared-memory sort.  Design, for Hopper:
//   - one block of 512 threads a read: the keys (up to 2^14, 128 KB) are
//     sorted in place in dynamic shared memory by a bitonic network over
//     the next power of two of the read's hits, padded with ~0;
//   - group starts are one bit a key (warp ballots), and each thread walks
//     the set bits of its words to size its groups, keeping its own top 4
//     of each strand in registers; eight block-wide max reductions pick
//     the kept groups, one warp a kept group subsamples and describes it;
//   - the kept anchors are written beside the read's hits in a staging
//     slab, then a second kernel (one block a read) gathers them into one
//     compact array, each block summing the kept counts before its own,
//     so that one copy of the kept anchors alone comes back.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                   // groups kept a strand
constexpr int kSlots = 2 * kPer;
constexpr int kMeta = 1 + 4 * kSlots;
constexpr int kCompactThreads = 256;
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned long long kQMask = (1ull << 19) - 1;
constexpr unsigned long long kAnchorMask = (1ull << 51) - 1;
constexpr int kMaxKeys = 1 << 14;

__device__ __forceinline__ long long gpos(unsigned long long key) {
  return static_cast<long long>((key >> 19) & 0xffffffffull);
}

// index of the chromosome holding g: upper_bound(off, off + n_off, g) - 1
__device__ __forceinline__ int chrom_of(const int64_t* __restrict__ off,
                                        int n_off, long long g) {
  int a = 0, b = n_off;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(off + mid) <= g) a = mid + 1; else b = mid;
  }
  return a - 1;
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
  for (int o = 16; o; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ void insert4(unsigned long long (&t)[kPer],
                                        unsigned long long v) {
  if (v <= t[3]) return;
  if (v > t[0]) {
    t[3] = t[2]; t[2] = t[1]; t[1] = t[0]; t[0] = v;
  } else if (v > t[1]) {
    t[3] = t[2]; t[2] = t[1]; t[1] = v;
  } else if (v > t[2]) {
    t[3] = t[2]; t[2] = v;
  } else {
    t[3] = v;
  }
}

__device__ __forceinline__ void pop4(unsigned long long (&t)[kPer]) {
  t[0] = t[1]; t[1] = t[2]; t[2] = t[3]; t[3] = 0;
}

__global__ void __launch_bounds__(kThreads)
seed_select_kernel(const int64_t* __restrict__ table,
                   const int64_t* __restrict__ chrom_off, int n_off,
                   const int32_t* __restrict__ lo,
                   const int64_t* __restrict__ cs,
                   const int64_t* __restrict__ hoff,
                   const int32_t* __restrict__ qoff,
                   const int32_t* __restrict__ qpack,
                   const int32_t* __restrict__ read_len, int k,
                   long long max_intron, int half_qgap, int a_max, int cap,
                   int n2max, int64_t* __restrict__ slab,
                   int64_t* __restrict__ meta) {
  extern __shared__ unsigned long long key[];
  __shared__ unsigned long long red[kWarps];
  __shared__ unsigned long long sel[kSlots];
  __shared__ int msel[kSlots];
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t* row = meta + static_cast<long long>(r) * kMeta;
  const long long h0 = hoff[r];
  const long long nh = hoff[r + 1] - h0;
  if (nh > cap || nh > n2max || nh == 0) {   // the whole block leaves
    if (tid < kMeta) row[tid] = (tid == 0 && nh != 0) ? -1 : 0;
    return;
  }
  const int n = static_cast<int>(nh);
  int n2 = 32;
  while (n2 < n) n2 <<= 1;
  unsigned* flag = reinterpret_cast<unsigned*>(key + n2);

  // 1. expand the read's hits into keys
  const int q0 = qoff[r], q1 = qoff[r + 1];
  const int len = read_len[r];
  for (int j = q0 + tid; j < q1; j += kThreads) {
    const long long e0 = j ? cs[j - 1] : 0;
    const int c = static_cast<int>(cs[j] - e0);
    const int o = static_cast<int>(e0 - h0);
    const int qp = qpack[j] >> 1, qs = qpack[j] & 1;
    const int64_t* ent = table + lo[j];
    for (int t = 0; t < c; ++t) {
      const unsigned long long e = static_cast<unsigned long long>(ent[t]);
      const unsigned st = static_cast<unsigned>(qs) ^
                          static_cast<unsigned>(e & 1ull);
      const unsigned long long qf =
          static_cast<unsigned long long>(st ? len - k - qp : qp);
      key[o + t] = (static_cast<unsigned long long>(st) << 51) |
                   ((e >> 1) << 19) | qf;
    }
  }
  for (int i = n + tid; i < n2; i += kThreads) key[i] = kNoKey;
  __syncthreads();

  // 2. bitonic sort, ascending
  for (int kk = 2; kk <= n2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < (n2 >> 1); i += kThreads) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int b = a + j;
        const unsigned long long x = key[a], y = key[b];
        if ((x > y) == ((a & kk) == 0)) {
          key[a] = y;
          key[b] = x;
        }
      }
      __syncthreads();
    }
  }

  // 3. group starts, one bit a key
  const int nw = (n + 31) >> 5;
  for (int w = warp; w < nw; w += kWarps) {
    const int i = (w << 5) + lane;
    bool start = false;
    if (i == 0) {
      start = true;
    } else if (i < n) {
      const unsigned long long a = key[i - 1], b = key[i];
      const long long ga = gpos(a), gb = gpos(b);
      start = ((a ^ b) >> 51) != 0 || gb - ga > max_intron ||
              chrom_of(chrom_off, n_off, ga) !=
                  chrom_of(chrom_off, n_off, gb);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, start);
    if (lane == 0) flag[w] = bits;
  }
  __syncthreads();

  // 4. each thread's top groups a strand, as count << 32 | ~start
  unsigned long long top0[kPer] = {0, 0, 0, 0}, top1[kPer] = {0, 0, 0, 0};
  for (int w = tid; w < nw; w += kThreads) {
    unsigned bits = flag[w];
    while (bits) {
      const int s = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1;
      int e;
      if (bits) {
        e = (w << 5) + __ffs(bits) - 1;
      } else {
        int w2 = w + 1;
        while (w2 < nw && flag[w2] == 0) ++w2;
        e = w2 < nw ? (w2 << 5) + __ffs(flag[w2]) - 1 : n;
      }
      const int c = e - s;
      if (c >= 2) {
        const unsigned long long v =
            (static_cast<unsigned long long>(c) << 32) |
            (0xffffffffu - static_cast<unsigned>(s));
        if ((key[s] >> 51) & 1ull) insert4(top1, v); else insert4(top0, v);
      }
    }
  }
  //    the block's top 4 a strand, one max reduction a slot
  for (int slot = 0; slot < kSlots; ++slot) {
    const bool minus = slot >= kPer;
    unsigned long long v = warp_max_u64(minus ? top1[0] : top0[0]);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = warp_max_u64(lane < kWarps ? red[lane] : 0ull);
      if (lane == 0) sel[slot] = v;
    }
    __syncthreads();
    const unsigned long long u = sel[slot];
    if (u != 0) {
      if (minus) {
        if (top1[0] == u) pop4(top1);
      } else if (top0[0] == u) {
        pop4(top0);
      }
    }
  }

  // 5. one warp a kept group: its size, then its subsample and row
  int gs = 0, gc = 0, gm = 0;
  if (warp < kSlots) {
    const unsigned long long v = sel[warp];
    if (v != 0) {
      gc = static_cast<int>(v >> 32);
      gs = static_cast<int>(0xffffffffu -
                            static_cast<unsigned>(v & 0xffffffffull));
      int qmn = INT_MAX, qmx = 0;
      for (int i = gs + lane; i < gs + gc; i += 32) {
        const int q = static_cast<int>(key[i] & kQMask);
        qmn = min(qmn, q);
        qmx = max(qmx, q);
      }
      qmn = __reduce_min_sync(0xffffffffu, qmn);
      qmx = __reduce_max_sync(0xffffffffu, qmx);
      const long long need = max(static_cast<long long>(a_max),
                                 static_cast<long long>(qmx - qmn) /
                                     half_qgap + 2);
      gm = static_cast<int>(min(static_cast<long long>(gc), need));
    }
    if (lane == 0) msel[warp] = gm;
  }
  __syncthreads();
  if (warp < kSlots) {
    int64_t* desc = row + 1 + 4 * warp;
    if (gm > 0) {
      int o = 0;
      for (int j = 0; j < warp; ++j) o += msel[j];
      int64_t* dst = slab + h0 + o;
      const long long span = gc - 1, den = gm - 1;
      int nbig = 0, qmax = 0;
      for (int w = lane; w < gm; w += 32) {
        const unsigned long long a =
            key[gs + static_cast<int>(w * span / den)];
        dst[w] = static_cast<int64_t>(a & kAnchorMask);
        qmax = max(qmax, static_cast<int>(a & kQMask));
        if (w > 0) {
          const unsigned long long p =
              key[gs + static_cast<int>((w - 1) * span / den)];
          nbig += gpos(a) - gpos(p) >= (1ll << 16);
        }
      }
      nbig = __reduce_add_sync(0xffffffffu, nbig);
      qmax = __reduce_max_sync(0xffffffffu, qmax);
      if (lane == 0) {
        desc[0] = gm;
        desc[1] = gpos(key[gs]);
        desc[2] = nbig;
        desc[3] = qmax;
      }
    } else if (lane < 4) {
      desc[lane] = 0;
    }
  }
  if (tid == 0) {
    int kept = 0;
    for (int j = 0; j < kSlots; ++j) kept += msel[j];
    row[0] = kept;
  }
}

// out[sum of the kept counts before r ...] = the read's kept anchors
__global__ void __launch_bounds__(kCompactThreads)
seed_compact_kernel(const int64_t* __restrict__ meta,
                    const int64_t* __restrict__ hoff,
                    const int64_t* __restrict__ slab,
                    int64_t* __restrict__ out) {
  __shared__ long long part[kCompactThreads / 32];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  long long before = 0;
  for (int j = tid; j < r; j += kCompactThreads) {
    const long long kept = meta[static_cast<long long>(j) * kMeta];
    before += kept > 0 ? kept : 0;
  }
  for (int o = 16; o; o >>= 1)
    before += __shfl_xor_sync(0xffffffffu, before, o);
  if ((tid & 31) == 0) part[tid >> 5] = before;
  __syncthreads();
  before = 0;
  for (int w = 0; w < kCompactThreads / 32; ++w) before += part[w];
  const long long kept = meta[static_cast<long long>(r) * kMeta];
  const int64_t* src = slab + hoff[r];
  for (long long i = tid; i < kept; i += kCompactThreads)
    out[before + i] = src[i];
}

}  // namespace

extern "C" {

// table: [n] int64 pos << 1 | strand; chrom_off: [n_off] int64 sorted;
// lo: [nq] int32; cs: [nq] int64 inclusive sum of the hit counts; hoff:
// [B + 1] int64 the reads' first hits; qoff: [B + 1] int32 the reads'
// first queries; qpack: [nq] int32 qpos << 1 | qstrand; read_len: [B]
// int32.  n2max: the power of two (32 .. 2^14) of keys a block holds in
// shared memory; cap <= n2max.  slab: [hoff[B]] int64 scratch; meta:
// [B, 33] int64 out; out: [hoff[B]] int64 out, of which the first sum of
// max(kept, 0) are written.  Returns cudaGetLastError().
int lr2_seed_select(const void* table, const void* chrom_off, int n_off,
                    const void* lo, const void* cs, const void* hoff,
                    const void* qoff, const void* qpack,
                    const void* read_len, int B, int k,
                    long long max_intron, int half_qgap, int a_max, int cap,
                    int n2max, void* slab, void* meta, void* out,
                    void* stream) {
  if (B < 0 || n_off < 1 || half_qgap < 1 || a_max < 2 || cap < 0 ||
      n2max < 32 || n2max > kMaxKeys || (n2max & (n2max - 1)) || cap > n2max)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(n2max) * 8 + n2max / 8;
  cudaError_t err = cudaFuncSetAttribute(
      seed_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  seed_select_kernel<<<B, kThreads, smem, s>>>(
      static_cast<const int64_t*>(table),
      static_cast<const int64_t*>(chrom_off), n_off,
      static_cast<const int32_t*>(lo), static_cast<const int64_t*>(cs),
      static_cast<const int64_t*>(hoff), static_cast<const int32_t*>(qoff),
      static_cast<const int32_t*>(qpack),
      static_cast<const int32_t*>(read_len), k, max_intron, half_qgap, a_max,
      cap, n2max, static_cast<int64_t*>(slab), static_cast<int64_t*>(meta));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seed_compact_kernel<<<B, kCompactThreads, 0, s>>>(
      static_cast<const int64_t*>(meta), static_cast<const int64_t*>(hoff),
      static_cast<const int64_t*>(slab), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
