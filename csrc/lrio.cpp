// lrio.cpp — native hot-path kernels for lr2rmats_tpu.
//
// The reference keeps its whole runtime in C (src/*.c + htslib); here the
// TPU owns the batched compute (chaining DP) and this library owns the
// ragged host-side inner loops that feed it:
//   * indel-aware splice-junction DP (mirrors align/splice.py, bit-equal)
//   * minimizer extraction (mirrors index/minimizer.py)
//   * chain backtrack
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC csrc/lrio.cpp -o build/liblrio.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <thread>
#include <atomic>

namespace {

constexpr double MATCH = 1.0;
constexpr double MISMATCH = -2.0;
constexpr double GAP = -3.0;
constexpr double NEG = -1e18;
constexpr double BONUS_CANON = 10.0;
constexpr double BONUS_SEMI = 8.0;
// anchor-position prior weight (align/splice.py W_POS; dyadic so the f32
// device kernel agrees bit-for-bit).  The penalty is a one-sided hinge:
// anchors are exact matches, so the junction can never sit INSIDE the
// anchored flank (donor offset < El or acceptor offset < Er) — such
// under-slides pay W_POS per base, while placements beyond the anchors
// (error slack before the junction) stay free.
constexpr double W_POS = 0.375;

// banded prefix DP (align/splice.py::_shift_dp)
// S has (m+1) x W doubles, W = 2B+1
void shift_dp(const uint8_t* q, int m, const uint8_t* win, int nw, int B,
              double* S) {
    const int W = 2 * B + 1;
    for (int i = 0; i < (m + 1) * W; ++i) S[i] = NEG;
    S[B] = 0.0;
    for (int s = 1; s <= B; ++s)
        if (s <= nw) S[B + s] = GAP * s;
    for (int j = 1; j <= m; ++j) {
        const double* prev = S + (j - 1) * W;
        double* row = S + j * W;
        double best = NEG;
        for (int c = 0; c < W; ++c) {
            int rlen = j + c - B;
            if (rlen < 0 || rlen > nw) { row[c] = NEG; best = NEG; continue; }
            double v = NEG;
            if (rlen >= 1 && prev[c] > NEG / 2) {
                double d = (win[rlen - 1] == q[j - 1]) ? MATCH : MISMATCH;
                v = prev[c] + d;
            }
            if (c + 1 < W && prev[c + 1] > NEG / 2) {
                double t = prev[c + 1] + GAP;
                if (t > v) v = t;
            }
            // deletion from row[c-1] (running best)
            best = std::max(best + GAP, v);
            row[c] = best;
        }
    }
}

// traceback of one DP cell -> (op,len) runs appended to out
// ops: 0=M 1=I 2=D. Returns count of runs.
int traceback(const uint8_t* q, const uint8_t* win, const double* S,
              int m, int B, int j, int c, int32_t* out_ops, int cap) {
    const int W = 2 * B + 1;
    std::vector<std::pair<int, int>> ops;
    auto push = [&](int op) {
        if (!ops.empty() && ops.back().first == op) ops.back().second++;
        else ops.emplace_back(op, 1);
    };
    while (j > 0 || c != B) {
        int rlen = j + c - B;
        double cur = S[j * W + c];
        bool stepped = false;
        if (j > 0 && rlen >= 1) {
            double d = (win[rlen - 1] == q[j - 1]) ? MATCH : MISMATCH;
            if (std::fabs(S[(j - 1) * W + c] + d - cur) < 1e-9) {
                push(0); --j; stepped = true;
            }
        }
        if (!stepped && c > 0 &&
            std::fabs(S[j * W + (c - 1)] + GAP - cur) < 1e-9) {
            push(2); --c; stepped = true;
        }
        if (!stepped && j > 0 && c + 1 < W &&
            std::fabs(S[(j - 1) * W + (c + 1)] + GAP - cur) < 1e-9) {
            push(1); --j; ++c; stepped = true;
        }
        if (!stepped) {
            if (j > 0 && rlen >= 1) { push(0); --j; }
            else if (j > 0) { push(1); --j; ++c; }
            else { push(2); --c; }
        }
    }
    int n = std::min((int)ops.size(), cap);
    for (int i = 0; i < n; ++i) {
        out_ops[2 * i] = ops[n - 1 - i].first;       // reversed
        out_ops[2 * i + 1] = ops[n - 1 - i].second;
    }
    return n;
}

inline int donor_class(const uint8_t* ref, int64_t n, int64_t d) {
    if (d < 0 || d + 1 >= n) return 0;
    uint8_t a = ref[d], b = ref[d + 1];
    if (a == 2 && b == 3) return 1;  // GT
    if (a == 1 && b == 3) return 2;  // CT
    if (a == 2 && b == 1) return 3;  // GC
    if (a == 0 && b == 3) return 4;  // AT
    return 0;
}
inline int acceptor_class(const uint8_t* ref, int64_t n, int64_t last) {
    if (last - 1 < 0 || last >= n) return 0;
    uint8_t a = ref[last - 1], b = ref[last];
    if (a == 0 && b == 2) return 1;  // AG
    if (a == 0 && b == 1) return 2;  // AC
    if (a == 2 && b == 1) return 3;  // GC
    if (a == 0 && b == 3) return 4;  // AT
    return 0;
}
inline void motif_bonus(int dc, int ac, double* bonus, int* vote) {
    *bonus = 0.0; *vote = 0;
    if (dc == 1 && ac == 1) { *bonus = BONUS_CANON; *vote = 1; }
    else if (dc == 2 && ac == 2) { *bonus = BONUS_CANON; *vote = -1; }
    else if (dc == 3 && ac == 1) { *bonus = BONUS_SEMI; *vote = 1; }
    else if (dc == 4 && ac == 2) { *bonus = BONUS_SEMI; *vote = 1; }
    else if (dc == 2 && ac == 3) { *bonus = BONUS_SEMI; *vote = -1; }
    else if (dc == 1 && ac == 4) { *bonus = BONUS_SEMI; *vote = -1; }
}

}  // namespace

extern "C" {

// Indel-aware intron placement (align/splice.py::refine_splice_indel).
// Returns 0 on success, -1 when no intron >= min_intron fits.
int refine_splice_indel_c(
    const uint8_t* q, int m, const uint8_t* ref, int64_t ref_len,
    int64_t left_ref, int64_t right_ref, int B, int min_intron,
    int el_exp, int er_exp,
    int32_t* left_ops, int32_t* left_n,
    int32_t* right_ops, int32_t* right_n,
    int64_t* intron_len, int32_t* vote_out, double* score_out) {
    const int W = 2 * B + 1;
    int64_t span = right_ref - left_ref;
    int nl = (int)std::min<int64_t>(m + B, span);
    int nr = (int)std::min<int64_t>(m + B, span);

    std::vector<uint8_t> lwin(ref + left_ref, ref + left_ref + nl);
    std::vector<uint8_t> rwin(nr);
    for (int i = 0; i < nr; ++i) rwin[i] = ref[right_ref - 1 - i];
    std::vector<uint8_t> qrev(q, q + m);
    std::reverse(qrev.begin(), qrev.end());

    std::vector<double> SL((m + 1) * W), SR((m + 1) * W);
    shift_dp(q, m, lwin.data(), nl, B, SL.data());
    shift_dp(qrev.data(), m, rwin.data(), nr, B, SR.data());

    // precompute donor/acceptor classes over candidate positions
    std::vector<int> dcls(m + 2 * B + 1), acls(m + 2 * B + 1);
    for (int i = 0; i <= m + 2 * B; ++i) {
        dcls[i] = donor_class(ref, ref_len, left_ref + i - B);
        acls[i] = acceptor_class(ref, ref_len, right_ref - (i - B) - 1);
    }

    double best = NEG;
    int bj = -1, bcl = -1, bcr = -1, bvote = 0;
    for (int j = 0; j <= m; ++j) {
        const double* sl = SL.data() + j * W;
        const double* sr = SR.data() + (m - j) * W;
        for (int cl = 0; cl < W; ++cl) {
            if (sl[cl] <= NEG / 2) continue;
            int64_t don = left_ref + (j + cl - B);
            if (don < 0 || don + 1 >= ref_len) continue;
            int dc = dcls[j + cl];
            double pen_l = W_POS * std::max(el_exp - (j + cl - B), 0);
            for (int cr = 0; cr < W; ++cr) {
                if (sr[cr] <= NEG / 2) continue;
                int64_t last = right_ref - ((m - j) + cr - B) - 1;
                if (last - 1 < 0 || last >= ref_len) continue;
                int64_t ilen = last - don + 1;
                if (ilen < min_intron) continue;
                double bonus; int vote;
                motif_bonus(dc, acls[(m - j) + cr], &bonus, &vote);
                double pen = pen_l +
                    W_POS * std::max(er_exp - ((m - j) + cr - B), 0);
                // >=: ties resolve to the LARGEST (j, cl, cr).  Wobble tie
                // intervals overwhelmingly carry the true junction at their
                // large end (the small end reuses pulled-back anchored
                // matches; the large end is reached through error slack),
                // so prefer the largest placement.
                double sc = sl[cl] + sr[cr] + bonus - pen;
                if (sc >= best) {
                    best = sc; bj = j; bcl = cl; bcr = cr; bvote = vote;
                }
            }
        }
    }
    if (bj < 0) return -1;
    int64_t don = left_ref + (bj + bcl - B);
    int64_t last = right_ref - ((m - bj) + bcr - B) - 1;
    *intron_len = last - don + 1;
    *vote_out = bvote;
    *score_out = best;
    *left_n = traceback(q, lwin.data(), SL.data(), m, B, bj, bcl,
                        left_ops, m + 2 * B + 4);
    // right side ops come out reversed twice (reversed query, reversed run
    // order) -> reverse the run list and the op order is already correct in
    // query direction after the double reversal below
    int rn = traceback(qrev.data(), rwin.data(), SR.data(), m, B, m - bj, bcr,
                       right_ops, m + 2 * B + 4);
    // traceback returns runs in forward order of the REVERSED query; the
    // forward-query order is the reverse of that run list
    for (int i = 0; i < rn / 2; ++i) {
        std::swap(right_ops[2 * i], right_ops[2 * (rn - 1 - i)]);
        std::swap(right_ops[2 * i + 1], right_ops[2 * (rn - 1 - i) + 1]);
    }
    *right_n = rn;
    return 0;
}

// Op recovery for a junction cell chosen by the DEVICE splice DP
// (ops/splice_device.py): recomputes only the two banded flank DPs and
// tracebacks at the given (j, cl, cr) — skipping the (m+1)*W^2 combine
// scan, which is the ~85% of refine_splice_indel_c the accelerator owns.
// Batched over cells; same output convention as refine_splice_indel_c.
int junction_cell_ops_batch_c(
    const uint8_t* qs, const int64_t* q_offs,     // ragged gap queries
    const uint8_t* ref, int64_t ref_len,
    const int64_t* left_ref, const int64_t* right_ref,
    const int32_t* cell_j, const int32_t* cell_cl, const int32_t* cell_cr,
    int B, int n_gap, int ops_stride,
    int32_t* left_ops, int32_t* left_n,
    int32_t* right_ops, int32_t* right_n) {
    const int W = 2 * B + 1;
    std::vector<double> SL, SR;
    std::vector<uint8_t> lwin, rwin, qrev;
    for (int i = 0; i < n_gap; ++i) {
        int m = (int)(q_offs[i + 1] - q_offs[i]);
        const uint8_t* q = qs + q_offs[i];
        int64_t span = right_ref[i] - left_ref[i];
        int nl = (int)std::min<int64_t>(m + B, span);
        int nr = nl;
        lwin.assign(ref + left_ref[i], ref + left_ref[i] + nl);
        rwin.resize(nr);
        for (int t = 0; t < nr; ++t) rwin[t] = ref[right_ref[i] - 1 - t];
        qrev.assign(q, q + m);
        std::reverse(qrev.begin(), qrev.end());
        SL.resize((size_t)(m + 1) * W);
        SR.resize((size_t)(m + 1) * W);
        shift_dp(q, m, lwin.data(), nl, B, SL.data());
        shift_dp(qrev.data(), m, rwin.data(), nr, B, SR.data());
        int bj = cell_j[i], bcl = cell_cl[i], bcr = cell_cr[i];
        left_n[i] = traceback(q, lwin.data(), SL.data(), m, B, bj, bcl,
                              left_ops + (int64_t)i * 2 * ops_stride,
                              ops_stride);
        int rn = traceback(qrev.data(), rwin.data(), SR.data(), m, B,
                           m - bj, bcr,
                           right_ops + (int64_t)i * 2 * ops_stride,
                           ops_stride);
        int32_t* ro = right_ops + (int64_t)i * 2 * ops_stride;
        for (int t = 0; t < rn / 2; ++t) {
            std::swap(ro[2 * t], ro[2 * (rn - 1 - t)]);
            std::swap(ro[2 * t + 1], ro[2 * (rn - 1 - t) + 1]);
        }
        right_n[i] = rn;
    }
    return 0;
}

// Minimizer extraction (index/minimizer.py::extract_minimizers).
// codes: uint8 [n_codes]; outputs hash/pos/strand arrays (cap = n_codes).
// Returns count.
int64_t extract_minimizers_c(const uint8_t* codes, int64_t n_codes,
                             int k, int w,
                             uint64_t* out_hash, int64_t* out_pos,
                             int8_t* out_strand) {
    int64_t n = n_codes - k + 1;
    if (n < w) return 0;
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const uint64_t BAD = ~0ULL;
    std::vector<uint64_t> h(n);
    std::vector<int8_t> strand(n);
    uint64_t fwd = 0, rc = 0;
    int valid_run = 0;
    const int shift_rc = 2 * (k - 1);
    for (int64_t i = 0; i < n_codes; ++i) {
        uint8_t c = codes[i];
        if (c < 4) {
            fwd = ((fwd << 2) | c) & mask;
            rc = (rc >> 2) | ((uint64_t)(3 - c) << shift_rc);
            if (valid_run < k) ++valid_run;  // clamp: only >= k matters; unclamped it overflows int past 2^31 contiguous bases
        } else {
            fwd = rc = 0; valid_run = 0;
        }
        int64_t p = i - k + 1;
        if (p >= 0) {
            if (valid_run >= k) {
                uint64_t canon; int8_t s;
                if (rc < fwd) { canon = rc; s = 1; } else { canon = fwd; s = 0; }
                // hash64 finalizer
                uint64_t x = canon;
                x = (~x + (x << 21)) & mask;
                x = x ^ (x >> 24);
                x = (x + (x << 3) + (x << 8)) & mask;
                x = x ^ (x >> 14);
                x = (x + (x << 2) + (x << 4)) & mask;
                x = x ^ (x >> 28);
                x = (x + (x << 31)) & mask;
                h[p] = x; strand[p] = s;
            } else {
                h[p] = BAD; strand[p] = 0;
            }
        }
    }
    // sliding window minimum, leftmost argmin, dedup on position.
    // Cached-argmin: the previous window's argmin stays valid until it
    // slides out, so most steps are ONE compare against the new rightmost
    // element; a full leftmost-argmin rescan happens only every >= w steps.
    // Measured ~1.9x the plain O(n*w) rescan at w=5 and ~9x at w=19
    // (monotonic deques lose to both below w~10 on random hashes).
    // Strict < keeps the EARLIEST index among equal values -> identical
    // output to the reference rescan (bit-equality tested).
    int64_t cnt = 0;
    int64_t last_pos = -1;
    int64_t arg = -1;  // argmin of the previous window, -1 = none
    for (int64_t wstart = 0; wstart + w <= n; ++wstart) {
        int64_t i = wstart + w - 1;          // new rightmost element
        if (arg >= wstart) {
            if (h[i] < h[arg]) arg = i;      // ties keep the older (leftmost)
        } else {
            arg = wstart;
            for (int64_t j = wstart + 1; j <= i; ++j)
                if (h[j] < h[arg]) arg = j;
        }
        if (h[arg] == BAD) continue;
        if (arg == last_pos) continue;
        out_hash[cnt] = h[arg];
        out_pos[cnt] = arg;
        out_strand[cnt] = strand[arg];
        ++cnt;
        last_pos = arg;
    }
    return cnt;
}

// Batched minimizer extraction: one call for a whole read batch instead of
// one ctypes crossing per read (~85 us each measured).  Read i's
// minimizers land at output offset read_offs[i] (count <= read length, so
// slots never collide); positions are READ-LOCAL.  Threaded over reads.
int extract_minimizers_batch_c(
    const uint8_t* reads, const int64_t* read_offs, int n_reads,
    int k, int w, int n_threads,
    uint64_t* out_hash, int64_t* out_pos, int8_t* out_strand,
    int64_t* out_n) {
    auto work = [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            int64_t off = read_offs[i];
            int64_t L = read_offs[i + 1] - off;
            out_n[i] = extract_minimizers_c(reads + off, L, k, w,
                                            out_hash + off, out_pos + off,
                                            out_strand + off);
        }
    };
    if (n_threads <= 1 || n_reads < 2 * n_threads) {
        work(0, n_reads);
    } else {
        std::vector<std::thread> ts;
        int per = (n_reads + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            int lo = t * per, hi = std::min(n_reads, lo + per);
            if (lo < hi) ts.emplace_back(work, lo, hi);
        }
        for (auto& th : ts) th.join();
    }
    return 0;
}

// Pure-split splice scan (align/splice.py::refine_splice): choose query
// split j in [0, m] maximizing prefix/suffix matches + motif bonus.
// Returns j; writes score and strand vote.
int refine_splice_c(const uint8_t* q, int m, const uint8_t* ref,
                    int64_t ref_len, int64_t left_ref, int64_t right_ref,
                    int el_exp, int er_exp,
                    double* score_out, int32_t* vote_out) {
    // prefix/suffix match cumsums
    std::vector<double> lpre(m + 1, 0.0), rsuf(m + 1, 0.0);
    for (int t = 0; t < m; ++t)
        lpre[t + 1] = lpre[t] + (q[t] == ref[left_ref + t] ? 1.0 : 0.0);
    for (int t = m - 1; t >= 0; --t)
        rsuf[t] = rsuf[t + 1] +
                  (q[t] == ref[right_ref - m + t] ? 1.0 : 0.0);
    double best = NEG;
    int bj = 0, bvote = 0;
    for (int j = 0; j <= m; ++j) {
        int64_t don = left_ref + j;
        int64_t acc = right_ref - (m - j) - 2;  // acceptor dinuc start
        double bp = 0.0, bm = 0.0;
        if (don >= 0 && don + 1 < ref_len && acc >= 0 && acc + 1 < ref_len) {
            uint8_t d0 = ref[don], d1 = ref[don + 1];
            uint8_t a0 = ref[acc], a1 = ref[acc + 1];
            bool GT = d0 == 2 && d1 == 3, CT = d0 == 1 && d1 == 3;
            bool GC_d = d0 == 2 && d1 == 1, AT_d = d0 == 0 && d1 == 3;
            bool AG = a0 == 0 && a1 == 2, AC = a0 == 0 && a1 == 1;
            bool GC_a = a0 == 2 && a1 == 1, AT_a = a0 == 0 && a1 == 3;
            if (GT && AG) bp = BONUS_CANON;
            else if ((GC_d && AG) || (AT_d && AC)) bp = BONUS_SEMI;
            if (CT && AC) bm = BONUS_CANON;
            else if ((CT && GC_a) || (GT && AT_a)) bm = BONUS_SEMI;
        }
        double bonus = std::max(bp, bm);
        // anchor-position prior: the junction cannot sit inside the anchored
        // flank (the edge pullback el/er_exp the extender applied); slides
        // into it pay per-base distance (one-sided hinge, see W_POS)
        double pen = W_POS * (std::max(el_exp - j, 0) +
                              std::max(er_exp - (m - j), 0));
        // >=: tie to the largest j (see refine_splice_indel_c)
        double sc = lpre[j] + rsuf[j] + bonus - pen;
        if (sc >= best) {
            best = sc; bj = j;
            bvote = (bp > bm) ? 1 : (bm > bp ? -1 : 0);
        }
    }
    *score_out = best;
    *vote_out = bvote;
    return bj;
}

// Chain backtrack (align/chain.py::backtrack): primary chain + best
// anchor-disjoint secondary.  Outputs index arrays (cap n each); returns 0.
// Scratch-parameterized core: chain_small_batch_c calls this once per row
// (millions of rows at 500k-read scale), so per-call heap allocation is
// hoisted into caller-owned buffers (each sized >= n).
static int backtrack_impl(const double* f, const int64_t* parent, int64_t n,
                          double min_score, int max_examine,
                          int64_t* primary, int64_t* pn,
                          int64_t* secondary, int64_t* sn,
                          double* pscore, double* sscore,
                          int64_t* order, uint8_t* used, int64_t* tmp) {
    *pn = 0; *sn = 0; *pscore = 0.0; *sscore = 0.0;
    if (n == 0) return 0;
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order, order + n,
                     [&](int64_t a, int64_t b) { return f[a] > f[b]; });
    std::memset(used, 0, (size_t)n);
    auto trace = [&](int64_t end, int64_t* out) {
        int64_t cnt = 0;
        for (int64_t i = end; i != -1; i = parent[i]) out[cnt++] = i;
        std::reverse(out, out + cnt);
        return cnt;
    };
    int64_t best_end = order[0];
    if (f[best_end] < min_score) return 0;
    *pn = trace(best_end, primary);
    *pscore = f[best_end];
    for (int64_t i = 0; i < *pn; ++i) used[primary[i]] = 1;
    int examined = 0;
    for (int64_t oi = 1; oi < n; ++oi) {
        int64_t e = order[oi];
        if (f[e] < min_score || examined >= max_examine) break;
        if (used[e]) continue;
        ++examined;
        int64_t cnt = trace(e, tmp);
        bool clean = true;
        for (int64_t i = 0; i < cnt; ++i)
            if (used[tmp[i]]) { clean = false; break; }
        if (clean) {
            std::memcpy(secondary, tmp, cnt * sizeof(int64_t));
            *sn = cnt;
            *sscore = f[e];
            break;
        }
    }
    return 0;
}

int backtrack_c(const double* f, const int64_t* parent, int64_t n,
                double min_score, int max_examine,
                int64_t* primary, int64_t* pn,
                int64_t* secondary, int64_t* sn,
                double* pscore, double* sscore) {
    if (n == 0) {
        *pn = 0; *sn = 0; *pscore = 0.0; *sscore = 0.0;
        return 0;
    }
    std::vector<int64_t> order(n), tmp(n);
    std::vector<uint8_t> used(n);
    return backtrack_impl(f, parent, n, min_score, max_examine,
                          primary, pn, secondary, sn, pscore, sscore,
                          order.data(), used.data(), tmp.data());
}

// Hamming distance of a read vs buffer at many candidate positions.
void hamming_many_c(const uint8_t* buf, int64_t n, const uint8_t* read,
                    int L, const int64_t* pos, int n_pos, int32_t* out_mm) {
    for (int i = 0; i < n_pos; ++i) {
        int64_t p = pos[i];
        if (p < 0 || p + L > n) { out_mm[i] = 1 << 30; continue; }
        int mm = 0;
        const uint8_t* b = buf + p;
        for (int t = 0; t < L; ++t) mm += (b[t] != read[t]);
        out_mm[i] = mm;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full chain extension (align/aligner.py::SpliceAligner._extend +
// _merge_chain_blocks + align/banded.py::banded_edit_path), one call per
// read candidate.  CIGAR op codes: M=0 I=1 D=2 N=3 S=4.
// ---------------------------------------------------------------------------

namespace {

// Decimal formatter shared by the SAM/GTF/detail/BED12 writers (they each
// had an identical local lambda).  Negates via uint64 so INT64_MIN is safe.
inline int64_t put_i64(uint8_t* out, int64_t o, int64_t v) {
    char tmp[24];
    int l = 0;
    uint64_t u = (v < 0) ? (uint64_t)(-(v + 1)) + 1 : (uint64_t)v;
    if (u == 0) tmp[l++] = '0';
    while (u) { tmp[l++] = (char)('0' + u % 10); u /= 10; }
    if (v < 0) tmp[l++] = '-';
    for (int i = l - 1; i >= 0; --i) out[o++] = (uint8_t)tmp[i];
    return o;
}

struct OpsBuf {
    int32_t* buf;
    int cap;
    int n = 0;
    bool overflowed = false;
    void push(int op, int64_t len) {
        // Once over capacity, stop entirely (merging a later same-code run
        // into the last *stored* run after a drop would corrupt the CIGAR);
        // the caller surfaces `overflowed` as a nonzero rc -> python fallback.
        if (len <= 0 || overflowed) return;
        if (n > 0 && buf[2 * (n - 1)] == op) {
            buf[2 * (n - 1) + 1] += (int32_t)len;
            return;
        }
        if (n >= cap) { overflowed = true; return; }
        buf[2 * n] = op;
        buf[2 * n + 1] = (int32_t)len;
        ++n;
    }
};

// chain anchors -> colinear blocks with intron-edge pullback (shared by
// extend_chain_c and the device-junction two-pass path).  Returns the block
// count, or -1 if more than max_blocks blocks were produced (callers fall
// back to an unbounded path; silently dropping trailing blocks would
// truncate long-read CIGARs).
struct Blk64 { int64_t q0, g0, len; };

// eler_out (2*max_blocks, may be null): per-gap pullback (El, Er) stored at
// the RIGHT block's index — the junction prior center (see extend_chain_c).
int build_blocks(const int64_t* cq, const int64_t* cg, int n_anchor, int k,
                 int min_intron_gap, Blk64* out, int max_blocks,
                 int32_t* eler_out = nullptr) {
    int nb = 0;
    int64_t q0 = cq[0], g0 = cg[0];
    int64_t qe = q0 + k, ge = g0 + k;
    for (int i = 1; i < n_anchor; ++i) {
        int64_t qi = cq[i], gi = cg[i];
        if (qi - q0 == gi - g0) {
            qe = std::max(qe, qi + k);
            ge = std::max(ge, gi + k);
            continue;
        }
        int64_t d = std::max(qe - qi, ge - gi);
        int64_t klen = k;
        if (d > 0) {
            if (d >= k) continue;
            qi += d; gi += d; klen = k - d;
        }
        if (nb >= max_blocks) return -1;
        out[nb++] = {q0, g0, qe - q0};
        q0 = qi; g0 = gi; qe = qi + klen; ge = gi + klen;
    }
    if (nb >= max_blocks) return -1;
    out[nb++] = {q0, g0, qe - q0};
    const int64_t E = 6;
    if (eler_out) std::fill(eler_out, eler_out + 2 * nb, 0);
    for (int i = 1; i < nb; ++i) {
        Blk64& pb = out[i - 1];
        Blk64& bb = out[i];
        int64_t gq = bb.q0 - (pb.q0 + pb.len);
        int64_t gg = bb.g0 - (pb.g0 + pb.len);
        if (gg - gq >= min_intron_gap) {
            int64_t El = pb.len > 8 ? std::min(E, pb.len - 8) : 0;
            int64_t Er = bb.len > 8 ? std::min(E, bb.len - 8) : 0;
            pb.len -= El;
            bb.q0 += Er; bb.g0 += Er; bb.len -= Er;
            if (eler_out) {
                eler_out[2 * i] = (int32_t)El;
                eler_out[2 * i + 1] = (int32_t)Er;
            }
        }
    }
    return nb;
}

// banded global edit path (banded.py::banded_edit_path); ops appended via
// cb(op, len) in M=0 I=1 D=2 codes.  Returns edit distance.
int banded_edit_path(const uint8_t* q, int m, const uint8_t* r, int n,
                     int band_pad, std::vector<std::pair<int, int>>& out) {
    out.clear();
    if (m == 0) {
        if (n) out.emplace_back(2, n);
        return n;
    }
    if (n == 0) {
        out.emplace_back(1, m);
        return m;
    }
    const int band = std::abs(n - m) + band_pad;
    const int width = 2 * band + 1;
    const int32_t INF = 1 << 30;
    std::vector<int32_t> dp((size_t)(m + 1) * width, INF);
    auto at = [&](int i, int c) -> int32_t& { return dp[(size_t)i * width + c]; };
    // col c at row i corresponds to j = i + (c - band)
    at(0, band) = 0;
    for (int j = 1; j <= std::min(n, band); ++j) at(0, band + j) = j;
    for (int i = 1; i <= m; ++i) {
        int jlo = std::max(0, i - band);
        int jhi = std::min(n, i + band);
        int32_t best = INF;
        for (int j = jlo; j <= jhi; ++j) {
            int c = j - i + band;
            int32_t ins = (c + 1 < width && at(i - 1, c + 1) < INF)
                              ? at(i - 1, c + 1) + 1 : INF;
            int32_t sub = INF;
            if (j >= 1 && at(i - 1, c) < INF)
                sub = at(i - 1, c) + (r[j - 1] != q[i - 1] ? 1 : 0);
            int32_t v = std::min(sub, ins);
            best = std::min(best >= INF ? INF : best + 1, v);
            at(i, c) = best;
        }
    }
    // traceback: diag -> I -> D (banded.py order)
    int i = m, j = n, ed = 0;
    std::vector<std::pair<int, int>> rev;
    auto push = [&](int op) {
        if (!rev.empty() && rev.back().first == op) rev.back().second++;
        else rev.emplace_back(op, 1);
    };
    while (i > 0 || j > 0) {
        int c = j - i + band;
        int32_t cur = (c >= 0 && c < width) ? at(i, c) : INF;
        if (i > 0 && j > 0 && c >= 0 && c < width) {
            int mism = (q[i - 1] != r[j - 1]) ? 1 : 0;
            if (at(i - 1, c) + mism == cur) {
                push(0); ed += mism; --i; --j; continue;
            }
        }
        if (i > 0 && c + 1 < width && at(i - 1, c + 1) + 1 == cur) {
            push(1); ++ed; --i; ++c; continue;
        }
        if (j > 0 && c - 1 >= 0 && at(i, c - 1) + 1 == cur) {
            push(2); ++ed; --j; continue;
        }
        if (i > 0 && j > 0) { push(0); ed += (q[i-1] != r[j-1]); --i; --j; }
        else if (i > 0) { push(1); ++ed; --i; }
        else { push(2); ++ed; --j; }
    }
    out.assign(rev.rbegin(), rev.rend());
    return ed;
}

}  // namespace

extern "C" {

int extend_chain_c(const uint8_t* codes, int64_t L,
                   const uint8_t* ref, int64_t ref_len,
                   int64_t chrom_lo, int64_t chrom_hi,
                   const int64_t* cq, const int64_t* cg, int n_anchor,
                   int k, int min_intron_gap, int min_intron_len,
                   int band_pad, int ext_match, int ext_mismatch,
                   int B_junc,
                   int64_t* pos_out, int32_t* ops_out, int32_t* n_ops_cap_io,
                   int64_t* ed_out, int64_t* nmatch_out, int32_t* vote_out) {
    if (n_anchor <= 0) return -1;
    // ---- merge chain anchors into colinear blocks + intron-edge pullback
    // (shared build_blocks; eler remembers the per-gap pullback (El, Er) —
    // the center of the junction prior's flat region, align/splice.py W_POS).
    // A chain of n anchors yields at most n blocks, so n_anchor+1 capacity
    // can never overflow here.
    std::vector<Blk64> blocks(n_anchor + 1);
    std::vector<int32_t> eler(2 * (n_anchor + 1), 0);
    {
        int nb = build_blocks(cq, cg, n_anchor, k, min_intron_gap,
                              blocks.data(), n_anchor + 1, eler.data());
        blocks.resize(nb);
    }

    OpsBuf ops{ops_out, *n_ops_cap_io};
    int64_t ed = 0, nmatch = 0;
    int32_t vote = 0;

    auto count_m = [&](int64_t qs, int64_t gs, int64_t l) {
        int64_t mism = 0;
        for (int64_t t = 0; t < l; ++t) mism += (codes[qs + t] != ref[gs + t]);
        ed += mism;
        nmatch += l - mism;
    };
    auto emit = [&](const std::vector<std::pair<int, int>>& sub,
                    int64_t qi, int64_t gi) -> int64_t {
        int64_t g_used = 0;
        for (auto& ol : sub) {
            ops.push(ol.first, ol.second);
            if (ol.first == 0) {
                count_m(qi, gi + g_used, ol.second);
                qi += ol.second;
                g_used += ol.second;
            } else if (ol.first == 1) {
                qi += ol.second;
                ed += ol.second;
            } else if (ol.first == 2) {
                g_used += ol.second;
                ed += ol.second;
            } else if (ol.first == 3) {
                g_used += ol.second;
            }
        }
        return g_used;
    };

    // ---- left end extension (drop-off, no indels)
    int64_t q0 = blocks[0].q0, g0 = blocks[0].g0;
    int64_t ext = std::min(q0, g0 - chrom_lo);
    int64_t take = 0;
    if (ext > 0) {
        double sc = 0.0, best = 0.0;
        int64_t arg = -1;
        for (int64_t t = 0; t < ext; ++t) {  // outward from the anchor
            sc += (codes[q0 - 1 - t] == ref[g0 - 1 - t]) ? ext_match
                                                         : -ext_mismatch;
            if (sc > best) { best = sc; arg = t; }
        }
        take = (best > 0) ? arg + 1 : 0;
    }
    *pos_out = g0 - take;
    ops.push(4, q0 - take);
    if (take) { ops.push(0, take); count_m(q0 - take, g0 - take, take); }

    std::vector<std::pair<int, int>> sub;
    std::vector<int32_t> lops(4 * (L + 16)), rops(4 * (L + 16));
    for (size_t bi = 0; bi < blocks.size(); ++bi) {
        if (bi > 0) {
            const Blk64& pb = blocks[bi - 1];
            const Blk64& bb = blocks[bi];
            int64_t gq = std::max<int64_t>(bb.q0 - (pb.q0 + pb.len), 0);
            int64_t gg = std::max<int64_t>(bb.g0 - (pb.g0 + pb.len), 0);
            int64_t pqe = pb.q0 + pb.len, pge = pb.g0 + pb.len;
            if (gg - gq >= min_intron_gap && gg - gq >= min_intron_len) {
                int el = eler[2 * bi], er = eler[2 * bi + 1];
                // fast path: clean split + canonical motif; the threshold
                // discounts the minimum achievable prior penalty so a
                // perfect split inside the flat region still qualifies
                double fsc; int32_t v;
                int j = refine_splice_c(codes + pqe, (int)gq, ref, ref_len,
                                        pge, bb.g0, el, er, &fsc, &v);
                if (fsc >= (double)gq + BONUS_CANON -
                        W_POS * (double)std::max<int64_t>(el + er - gq, 0)) {
                    vote += v;
                    int64_t intron = gg - gq;
                    if (j) { ops.push(0, j); count_m(pqe, pge, j); }
                    ops.push(3, intron);
                    int64_t rest = gq - j;
                    if (rest) {
                        ops.push(0, rest);
                        count_m(pqe + j, bb.g0 - rest, rest);
                    }
                } else {
                    int32_t ln = 0, rn = 0, v2 = 0;
                    int64_t ilen = 0;
                    double sc2 = 0;
                    int rc = refine_splice_indel_c(
                        codes + pqe, (int)gq, ref, ref_len, pge, bb.g0,
                        B_junc, min_intron_len, el, er, lops.data(), &ln,
                        rops.data(), &rn, &ilen, &v2, &sc2);
                    if (rc == 0) {
                        vote += v2;
                        sub.clear();
                        int64_t lq = 0;
                        for (int t = 0; t < ln; ++t) {
                            sub.emplace_back(lops[2 * t], lops[2 * t + 1]);
                            if (lops[2 * t] != 2) lq += lops[2 * t + 1];
                        }
                        int64_t g_used = emit(sub, pqe, pge);
                        ops.push(3, ilen);
                        sub.clear();
                        for (int t = 0; t < rn; ++t)
                            sub.emplace_back(rops[2 * t], rops[2 * t + 1]);
                        emit(sub, pqe + lq, pge + g_used + ilen);
                    } else {
                        banded_edit_path(codes + pqe, (int)gq, ref + pge,
                                         (int)gg, band_pad, sub);
                        emit(sub, pqe, pge);
                    }
                }
            } else if (gq == gg) {
                ops.push(0, gq);
                count_m(pqe, pge, gq);
            } else {
                banded_edit_path(codes + pqe, (int)gq, ref + pge, (int)gg,
                                 band_pad, sub);
                emit(sub, pqe, pge);
            }
        }
        ops.push(0, blocks[bi].len);
        count_m(blocks[bi].q0, blocks[bi].g0, blocks[bi].len);
    }

    // ---- right end extension
    const Blk64& lb = blocks.back();
    int64_t qend = lb.q0 + lb.len, gend = lb.g0 + lb.len;
    int64_t rem = L - qend;
    ext = std::min(rem, chrom_hi - gend);
    take = 0;
    if (ext > 0) {
        double sc = 0.0, best = 0.0;
        int64_t arg = -1;
        for (int64_t t = 0; t < ext; ++t) {
            sc += (codes[qend + t] == ref[gend + t]) ? ext_match
                                                     : -ext_mismatch;
            if (sc > best) { best = sc; arg = t; }
        }
        take = (best > 0) ? arg + 1 : 0;
    }
    if (take) { ops.push(0, take); count_m(qend, gend, take); }
    ops.push(4, L - qend - take);

    if (ops.overflowed) return -2;  // caller retries via the python path
    *n_ops_cap_io = ops.n;
    *ed_out = ed;
    *nmatch_out = nmatch;
    *vote_out = vote;
    return 0;
}

}  // extern "C"

extern "C" {

// ---- Device-junction two-pass extension -----------------------------------
//
// Pass 1 (collect): block merge + intron-gap discovery.  Clean gaps (exact
// split + canonical motif, the refine_splice fast path) are resolved here;
// the rest are emitted for the DEVICE splice DP (ops/splice_device.py).
// Pass 2 (assemble) stitches blocks + device placements into CIGARs.
//
// Gap records are strided per candidate (GSTRIDE slots); jflag: 0 = device
// (query in jq, length jqlen), 1 = clean split (jclean_j/jclean_vote),
// 2 = native refine in assemble (query too long for the device pad).
int collect_gaps_batch_c(
    const uint8_t* reads, const int64_t* read_offs,
    const uint8_t* ref, int64_t ref_len,
    const int32_t* cand_read, const int8_t* cand_strand,
    const int64_t* aq, const int64_t* ag, const int64_t* a_offs,
    int k, int min_intron_gap, int min_intron_len, int mgap_cap,
    int n_cand, int blk_stride, int gstride,
    int64_t* blocks_out,     // [n_cand * blk_stride * 3]
    int32_t* n_blocks_out,   // [n_cand]
    int8_t* jflag,           // [n_cand * gstride]
    uint8_t* jq,             // [n_cand * gstride * mgap_cap]
    int32_t* jqlen,          // [n_cand * gstride]
    int64_t* jlref, int64_t* jrref,
    int32_t* jclean_j, int32_t* jclean_vote,
    int32_t* jel, int32_t* jer,   // [n_cand * gstride] prior centers
    int32_t* n_junc_out,     // [n_cand] (-1 = overflow -> caller fallback)
    int n_threads) {
    auto work = [&](int lo_c, int hi_c) {
        std::vector<uint8_t> rcbuf;
        std::vector<Blk64> blk(blk_stride);
        std::vector<int32_t> eler(2 * blk_stride);
        for (int i = lo_c; i < hi_c; ++i) {
            int ri = cand_read[i];
            const uint8_t* codes = reads + read_offs[ri];
            int64_t L = read_offs[ri + 1] - read_offs[ri];
            if (cand_strand[i]) {
                rcbuf.resize((size_t)L);
                for (int64_t t = 0; t < L; ++t) {
                    uint8_t c = codes[L - 1 - t];
                    rcbuf[(size_t)t] = c < 4 ? (uint8_t)(3 - c) : c;
                }
                codes = rcbuf.data();
            }
            const int64_t* cq = aq + a_offs[i];
            const int64_t* cg = ag + a_offs[i];
            int na = (int)(a_offs[i + 1] - a_offs[i]);
            if (na <= 0) { n_blocks_out[i] = 0; n_junc_out[i] = 0; continue; }
            int nb = build_blocks(cq, cg, na, k, min_intron_gap, blk.data(),
                                  blk_stride, eler.data());
            if (nb < 0) {  // >blk_stride blocks: route to the unbounded host path
                n_blocks_out[i] = 0;
                n_junc_out[i] = -1;
                continue;
            }
            n_blocks_out[i] = nb;
            for (int b = 0; b < nb; ++b) {
                blocks_out[((int64_t)i * blk_stride + b) * 3 + 0] = blk[b].q0;
                blocks_out[((int64_t)i * blk_stride + b) * 3 + 1] = blk[b].g0;
                blocks_out[((int64_t)i * blk_stride + b) * 3 + 2] = blk[b].len;
            }
            int nj = 0;
            bool overflow = false;
            for (int b = 1; b < nb && !overflow; ++b) {
                int64_t pqe = blk[b - 1].q0 + blk[b - 1].len;
                int64_t pge = blk[b - 1].g0 + blk[b - 1].len;
                int64_t gq = std::max<int64_t>(blk[b].q0 - pqe, 0);
                int64_t gg = std::max<int64_t>(blk[b].g0 - pge, 0);
                if (!(gg - gq >= min_intron_gap && gg - gq >= min_intron_len))
                    continue;
                if (nj >= gstride) { overflow = true; break; }
                int64_t gi = (int64_t)i * gstride + nj;
                jlref[gi] = pge;
                jrref[gi] = blk[b].g0;
                int el = eler[2 * b], er = eler[2 * b + 1];
                jel[gi] = el;
                jer[gi] = er;
                double fsc; int32_t v;
                int jsplit = refine_splice_c(codes + pqe, (int)gq, ref,
                                             ref_len, pge, blk[b].g0,
                                             el, er, &fsc, &v);
                if (fsc >= (double)gq + BONUS_CANON -
                        W_POS * (double)std::max<int64_t>(el + er - gq, 0)) {
                    jflag[gi] = 1;
                    jclean_j[gi] = jsplit;
                    jclean_vote[gi] = v;
                    jqlen[gi] = (int32_t)gq;
                } else if (gq <= mgap_cap) {
                    jflag[gi] = 0;
                    jqlen[gi] = (int32_t)gq;
                    std::memcpy(jq + gi * mgap_cap, codes + pqe, (size_t)gq);
                } else {
                    jflag[gi] = 2;
                    jqlen[gi] = (int32_t)gq;
                }
                ++nj;
            }
            n_junc_out[i] = overflow ? -1 : nj;
        }
    };
    if (n_threads <= 1 || n_cand < 2 * n_threads) {
        work(0, n_cand);
    } else {
        std::vector<std::thread> ts;
        int per = (n_cand + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            int lo = t * per, hi = std::min(n_cand, lo + per);
            if (lo < hi) ts.emplace_back(work, lo, hi);
        }
        for (auto& th : ts) th.join();
    }
    return 0;
}

// Pass 2: stitch blocks + junction results into CIGARs (the non-junction
// parts of extend_chain_c: end extensions, match runs, banded fills,
// NM/nmatch accounting).  Device gaps consume dev_* arrays in candidate
// order via dev_offs; found=0 falls back to the banded fill, exactly as a
// host refine miss would.
int assemble_ops_batch_c(
    const uint8_t* reads, const int64_t* read_offs,
    const uint8_t* ref, int64_t ref_len,
    const int64_t* chrom_offs, int n_chrom,
    const int32_t* cand_read, const int8_t* cand_strand,
    const int64_t* blocks, const int32_t* n_blocks,
    const int8_t* jflag, const uint8_t* jq, const int32_t* jqlen,
    const int64_t* jlref, const int64_t* jrref,
    const int32_t* jclean_j, const int32_t* jclean_vote,
    const int32_t* jel, const int32_t* jer,
    const int32_t* n_junc,
    const int64_t* dev_offs,          // [n_cand+1] device-gap index range
    const uint8_t* dev_found,         // [n_dev]
    const int64_t* dev_ilen, const int32_t* dev_vote,
    const int32_t* dev_lo, const int32_t* dev_ln,
    const int32_t* dev_ro, const int32_t* dev_rn, int dev_stride,
    int k, int min_intron_gap, int min_intron_len, int band_pad,
    int ext_match, int ext_mismatch, int B_junc,
    int n_cand, int blk_stride, int gstride, int ops_stride, int n_threads,
    int64_t* pos_out, int32_t* ops_out, int32_t* n_ops_out,
    int64_t* ed_out, int64_t* nmatch_out, int32_t* vote_out,
    int32_t* rc_out) {
    auto work = [&](int lo_c, int hi_c) {
        std::vector<uint8_t> rcbuf;
        std::vector<std::pair<int, int>> sub;
        std::vector<int32_t> lops, rops;
        for (int i = lo_c; i < hi_c; ++i) {
            int nb = n_blocks[i];
            if (nb <= 0 || n_junc[i] < 0) { rc_out[i] = -1; n_ops_out[i] = 0;
                                            continue; }
            int ri = cand_read[i];
            const uint8_t* codes = reads + read_offs[ri];
            int64_t L = read_offs[ri + 1] - read_offs[ri];
            if (cand_strand[i]) {
                rcbuf.resize((size_t)L);
                for (int64_t t = 0; t < L; ++t) {
                    uint8_t c = codes[L - 1 - t];
                    rcbuf[(size_t)t] = c < 4 ? (uint8_t)(3 - c) : c;
                }
                codes = rcbuf.data();
            }
            const int64_t* blk = blocks + (int64_t)i * blk_stride * 3;
            auto BQ = [&](int b) { return blk[3 * b]; };
            auto BG = [&](int b) { return blk[3 * b + 1]; };
            auto BL = [&](int b) { return blk[3 * b + 2]; };
            const int64_t* ub = std::upper_bound(chrom_offs,
                                                 chrom_offs + n_chrom + 1,
                                                 BG(0));
            int ci = (int)(ub - chrom_offs) - 1;
            int64_t chrom_lo = chrom_offs[ci], chrom_hi = chrom_offs[ci + 1];

            OpsBuf ops{ops_out + (int64_t)i * 2 * ops_stride, ops_stride};
            int64_t ed = 0, nmatch = 0;
            int32_t vote = 0;
            auto count_m = [&](int64_t qs, int64_t gs, int64_t l) {
                int64_t mism = 0;
                for (int64_t t = 0; t < l; ++t)
                    mism += (codes[qs + t] != ref[gs + t]);
                ed += mism;
                nmatch += l - mism;
            };
            auto emit = [&](const std::vector<std::pair<int, int>>& s,
                            int64_t qi, int64_t gi) -> int64_t {
                int64_t g_used = 0;
                for (auto& ol : s) {
                    ops.push(ol.first, ol.second);
                    if (ol.first == 0) {
                        count_m(qi, gi + g_used, ol.second);
                        qi += ol.second;
                        g_used += ol.second;
                    } else if (ol.first == 1) {
                        qi += ol.second; ed += ol.second;
                    } else if (ol.first == 2) {
                        g_used += ol.second; ed += ol.second;
                    } else if (ol.first == 3) {
                        g_used += ol.second;
                    }
                }
                return g_used;
            };

            // left end extension
            int64_t q0 = BQ(0), g0 = BG(0);
            int64_t ext = std::min(q0, g0 - chrom_lo);
            int64_t take = 0;
            if (ext > 0) {
                double sc = 0.0, best = 0.0;
                int64_t arg = -1;
                for (int64_t t = 0; t < ext; ++t) {
                    sc += (codes[q0 - 1 - t] == ref[g0 - 1 - t])
                              ? ext_match : -ext_mismatch;
                    if (sc > best) { best = sc; arg = t; }
                }
                take = (best > 0) ? arg + 1 : 0;
            }
            pos_out[i] = g0 - take;
            ops.push(4, q0 - take);
            if (take) { ops.push(0, take); count_m(q0 - take, g0 - take, take); }

            int nj_used = 0;
            int64_t dev_i = dev_offs[i];
            for (int b = 0; b < nb; ++b) {
                if (b > 0) {
                    int64_t pqe = BQ(b - 1) + BL(b - 1);
                    int64_t pge = BG(b - 1) + BL(b - 1);
                    int64_t gq = std::max<int64_t>(BQ(b) - pqe, 0);
                    int64_t gg = std::max<int64_t>(BG(b) - pge, 0);
                    if (gg - gq >= min_intron_gap && gg - gq >= min_intron_len) {
                        int64_t gi = (int64_t)i * gstride + nj_used;
                        int flag = jflag[gi];
                        ++nj_used;
                        if (flag == 1) {
                            // clean split (collect's fast path)
                            vote += jclean_vote[gi];
                            int64_t intron = gg - gq;
                            int jsplit = jclean_j[gi];
                            if (jsplit) { ops.push(0, jsplit);
                                          count_m(pqe, pge, jsplit); }
                            ops.push(3, intron);
                            int64_t rest = gq - jsplit;
                            if (rest) { ops.push(0, rest);
                                        count_m(pqe + jsplit, BG(b) - rest,
                                                rest); }
                        } else {
                            bool done = false;
                            int32_t ln = 0, rn = 0, v2 = 0;
                            int64_t ilen = 0;
                            const int32_t* lptr = nullptr;
                            const int32_t* rptr = nullptr;
                            if (flag == 0) {
                                int64_t d = dev_i++;
                                if (dev_found[d]) {
                                    ilen = dev_ilen[d];
                                    v2 = dev_vote[d];
                                    ln = dev_ln[d];
                                    rn = dev_rn[d];
                                    lptr = dev_lo + d * 2 * dev_stride;
                                    rptr = dev_ro + d * 2 * dev_stride;
                                    done = true;
                                }
                            } else {  // flag == 2: native full refine
                                lops.resize(4 * (gq + 16));
                                rops.resize(4 * (gq + 16));
                                double sc2 = 0;
                                if (refine_splice_indel_c(
                                        codes + pqe, (int)gq, ref, ref_len,
                                        pge, BG(b), B_junc, min_intron_len,
                                        jel[gi], jer[gi],
                                        lops.data(), &ln, rops.data(), &rn,
                                        &ilen, &v2, &sc2) == 0) {
                                    lptr = lops.data();
                                    rptr = rops.data();
                                    done = true;
                                }
                            }
                            if (done) {
                                vote += v2;
                                sub.clear();
                                int64_t lq = 0;
                                for (int t = 0; t < ln; ++t) {
                                    sub.emplace_back(lptr[2 * t],
                                                     lptr[2 * t + 1]);
                                    if (lptr[2 * t] != 2) lq += lptr[2 * t + 1];
                                }
                                int64_t g_used = emit(sub, pqe, pge);
                                ops.push(3, ilen);
                                sub.clear();
                                for (int t = 0; t < rn; ++t)
                                    sub.emplace_back(rptr[2 * t],
                                                     rptr[2 * t + 1]);
                                emit(sub, pqe + lq, pge + g_used + ilen);
                            } else {
                                banded_edit_path(codes + pqe, (int)gq,
                                                 ref + pge, (int)gg,
                                                 band_pad, sub);
                                emit(sub, pqe, pge);
                            }
                        }
                    } else if (gq == gg) {
                        ops.push(0, gq);
                        count_m(pqe, pge, gq);
                    } else {
                        banded_edit_path(codes + pqe, (int)gq, ref + pge,
                                         (int)gg, band_pad, sub);
                        emit(sub, pqe, pge);
                    }
                }
                ops.push(0, BL(b));
                count_m(BQ(b), BG(b), BL(b));
            }

            // right end extension
            int64_t qend = BQ(nb - 1) + BL(nb - 1);
            int64_t gend = BG(nb - 1) + BL(nb - 1);
            int64_t rem = L - qend;
            ext = std::min(rem, chrom_hi - gend);
            take = 0;
            if (ext > 0) {
                double sc = 0.0, best = 0.0;
                int64_t arg = -1;
                for (int64_t t = 0; t < ext; ++t) {
                    sc += (codes[qend + t] == ref[gend + t])
                              ? ext_match : -ext_mismatch;
                    if (sc > best) { best = sc; arg = t; }
                }
                take = (best > 0) ? arg + 1 : 0;
            }
            if (take) { ops.push(0, take); count_m(qend, gend, take); }
            ops.push(4, L - qend - take);

            n_ops_out[i] = ops.n;
            ed_out[i] = ed;
            nmatch_out[i] = nmatch;
            vote_out[i] = vote;
            rc_out[i] = ops.overflowed ? -2 : 0;  // -> per-candidate python fallback
        }
    };
    if (n_threads <= 1 || n_cand < 2 * n_threads) {
        work(0, n_cand);
    } else {
        std::vector<std::thread> ts;
        int per = (n_cand + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            int lo = t * per, hi = std::min(n_cand, lo + per);
            if (lo < hi) ts.emplace_back(work, lo, hi);
        }
        for (auto& th : ts) th.join();
    }
    return 0;
}

// Batched splice-aware chain extension: one call per aligner batch instead
// of one ctypes crossing per candidate (~85 us each measured).  Candidates
// carry ragged anchor lists (a_offs offsets into aq/ag); each candidate's
// ops go to a fixed-stride slot of ops_out (stride = ops_stride PAIRS).
// Strand-1 candidates are reverse-complemented here (io/fasta._COMP:
// A<->T, C<->G, N->N).  Threaded over candidate ranges (the work is
// read-only on shared inputs and strided on outputs).
int extend_chain_batch_c(
    const uint8_t* reads, const int64_t* read_offs,
    const uint8_t* ref, int64_t ref_len,
    const int64_t* chrom_offs, int n_chrom,
    const int32_t* cand_read, const int8_t* cand_strand,
    const int64_t* aq, const int64_t* ag, const int64_t* a_offs,
    int k, int min_intron_gap, int min_intron_len, int band_pad,
    int ext_match, int ext_mismatch, int B_junc,
    int n_cand, int ops_stride, int n_threads,
    int64_t* pos_out, int32_t* ops_out, int32_t* n_ops_out,
    int64_t* ed_out, int64_t* nmatch_out, int32_t* vote_out,
    int32_t* rc_out) {
    auto work = [&](int lo, int hi) {
        std::vector<uint8_t> rcbuf;
        for (int i = lo; i < hi; ++i) {
            int ri = cand_read[i];
            const uint8_t* codes = reads + read_offs[ri];
            int64_t L = read_offs[ri + 1] - read_offs[ri];
            if (cand_strand[i]) {
                rcbuf.resize((size_t)L);
                for (int64_t t = 0; t < L; ++t) {
                    uint8_t c = codes[L - 1 - t];
                    rcbuf[(size_t)t] = c < 4 ? (uint8_t)(3 - c) : c;
                }
                codes = rcbuf.data();
            }
            const int64_t* cq = aq + a_offs[i];
            const int64_t* cg = ag + a_offs[i];
            int na = (int)(a_offs[i + 1] - a_offs[i]);
            if (na <= 0) { rc_out[i] = -1; n_ops_out[i] = 0; continue; }
            const int64_t* ub = std::upper_bound(chrom_offs,
                                                 chrom_offs + n_chrom + 1,
                                                 cg[0]);
            int t = (int)(ub - chrom_offs) - 1;
            int32_t cap = ops_stride;
            rc_out[i] = extend_chain_c(
                codes, L, ref, ref_len, chrom_offs[t], chrom_offs[t + 1],
                cq, cg, na, k, min_intron_gap, min_intron_len, band_pad,
                ext_match, ext_mismatch, B_junc,
                pos_out + i, ops_out + (int64_t)i * 2 * ops_stride, &cap,
                ed_out + i, nmatch_out + i, vote_out + i);
            n_ops_out[i] = cap;
        }
    };
    if (n_threads <= 1 || n_cand < 2 * n_threads) {
        work(0, n_cand);
    } else {
        std::vector<std::thread> ts;
        int per = (n_cand + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; ++t) {
            int lo = t * per, hi = std::min(n_cand, lo + per);
            if (lo < hi) ts.emplace_back(work, lo, hi);
        }
        for (auto& th : ts) th.join();
    }
    return 0;
}

}  // extern "C"

extern "C" {

// One-pass FASTA parse: byte buffer -> packed codes + record offsets +
// header-name spans.  numpy's elementwise ops run at ~70-150 MB/s on this
// host (erratic), so the vectorized parse lost to a C scan by ~10x.
// Caller sizes rec arrays by count('>').  Returns the record count.
int64_t fasta_parse_c(const uint8_t* buf, int64_t n,
                      uint8_t* codes_out, int64_t* rec_off,
                      int64_t* name_off, int32_t* name_len,
                      int64_t* total_codes_out) {
    // Block-scope static with a constructor: C++11 guarantees thread-safe
    // one-time init (per-sample stages call this concurrently from a
    // ThreadPoolExecutor with the GIL released; the old bool-flag lazy init
    // was a data race).
    struct CodeTab {
        uint8_t t[256];
        CodeTab() {
            for (int i = 0; i < 256; ++i) t[i] = 4;
            t['A'] = t['a'] = 0;
            t['C'] = t['c'] = 1;
            t['G'] = t['g'] = 2;
            t['T'] = t['t'] = 3;
        }
    };
    static const CodeTab tab_s;
    const uint8_t* tab = tab_s.t;
    int64_t nr = 0, nc = 0, i = 0;
    while (i < n) {
        if (buf[i] == '>') {
            // close previous record, open new
            rec_off[nr] = nc;
            ++i;
            int64_t ns = i;
            while (i < n && buf[i] != '\n' && buf[i] != ' ' &&
                   buf[i] != '\t' && buf[i] != '\r')
                ++i;
            name_off[nr] = ns;
            name_len[nr] = (int32_t)(i - ns);
            ++nr;
            while (i < n && buf[i] != '\n') ++i;  // rest of header
            ++i;
        } else {
            // sequence line
            while (i < n && buf[i] != '\n') {
                uint8_t c = buf[i];
                if (c != '\r') codes_out[nc++] = tab[c];
                ++i;
            }
            ++i;
        }
    }
    rec_off[nr] = nc;
    *total_codes_out = nc;
    return nr;
}

// Rolling k-mer scan: km_out[i] = 2-bit packed codes[i..i+k), ok_out[i] = 1
// when the window has no ambiguous base (junctions/sjcount.py::_kmers).
// One pass; the numpy rolling construction moves ~2*k full-array copies.
void kmer_scan_c(const uint8_t* codes, int64_t n, int k,
                 uint64_t* km_out, int8_t* ok_out) {
    int64_t m = n - k + 1;
    if (m <= 0) return;
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    uint64_t km = 0;
    int run = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t c = codes[i];
        km = ((km << 2) | (c & 3)) & mask;
        run = (c < 4) ? (run < k ? run + 1 : run) : 0;  // clamp at k (int overflow on >2^31-base N-free stretches)
        if (i >= k - 1) {
            km_out[i - k + 1] = km;
            ok_out[i - k + 1] = run >= k;
        }
    }
}

// k-mers at arbitrary positions (seed extraction: only seeds_per_read
// positions per read are ever used — no need to scan the whole buffer).
void kmers_at_c(const uint8_t* codes, int64_t n, int k,
                const int64_t* pos, int64_t n_pos,
                uint64_t* km_out, int8_t* ok_out) {
    for (int64_t t = 0; t < n_pos; ++t) {
        int64_t p = pos[t];
        if (p < 0 || p + k > n) { km_out[t] = 0; ok_out[t] = 0; continue; }
        uint64_t km = 0;
        int ok = 1;
        for (int j = 0; j < k; ++j) {
            uint8_t c = codes[p + j];
            ok &= (c < 4);
            km = (km << 2) | (c & 3);
        }
        km_out[t] = km;
        ok_out[t] = (int8_t)ok;
    }
}

// Full seed-table build: k-mer scan + valid compaction + LSD radix sort by
// key (4x16-bit passes).  Returns the table size.  The numpy pipeline
// (argsort + two permutation gathers over ~46M entries) cost ~33 s at
// chr21 scale; this runs in ~2 s and scales to GRCh38.
int64_t build_kmer_table_c(const uint8_t* codes, int64_t n, int k,
                           int64_t pos_offset,
                           uint64_t* h_out, int64_t* pos_out) {
    int64_t m = n - k + 1;
    if (m <= 0) return 0;
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    // scan + compact directly into the output buffers
    int64_t cnt = 0;
    {
        uint64_t km = 0;
        int run = 0;
        for (int64_t i = 0; i < n; ++i) {
            uint8_t c = codes[i];
            km = ((km << 2) | (c & 3)) & mask;
            run = (c < 4) ? (run < k ? run + 1 : run) : 0;  // clamp at k (whole-genome calls exceed int32 runs)
            if (i >= k - 1 && run >= k) {
                h_out[cnt] = km;
                pos_out[cnt] = i - k + 1 + pos_offset;
                ++cnt;
            }
        }
    }
    // radix sort (key, payload) by 16-bit digits, only digits the key uses
    int n_pass = (2 * k + 15) / 16;
    std::vector<uint64_t> hb(cnt);
    std::vector<int64_t> pb(cnt);
    uint64_t* hs = h_out;  int64_t* ps = pos_out;
    uint64_t* hd = hb.data(); int64_t* pd = pb.data();
    std::vector<int64_t> hist(65536 + 1);
    for (int pass = 0; pass < n_pass; ++pass) {
        int shift = 16 * pass;
        std::fill(hist.begin(), hist.end(), 0);
        for (int64_t i = 0; i < cnt; ++i)
            ++hist[((hs[i] >> shift) & 0xFFFF) + 1];
        for (int b = 0; b < 65536; ++b) hist[b + 1] += hist[b];
        for (int64_t i = 0; i < cnt; ++i) {
            int64_t d = hist[(hs[i] >> shift) & 0xFFFF]++;
            hd[d] = hs[i];
            pd[d] = ps[i];
        }
        std::swap(hs, hd);
        std::swap(ps, pd);
    }
    if (hs != h_out) {
        std::memcpy(h_out, hs, (size_t)cnt * 8);
        std::memcpy(pos_out, ps, (size_t)cnt * 8);
    }
    return cnt;
}

// Sort a minimizer table (hash + pos + strand payloads) by hash with a
// threaded LSD radix (4x16-bit passes), then histogram run lengths (counts
// capped into the last bucket) so the caller can derive the occurrence-cap
// quantile without a second giant sort.  numpy argsort + unique cannot
// reach the ~1G-entry GRCh38 table on this host.
int sort_minimizer_table_c(uint64_t* h, int64_t* pos, int8_t* strand,
                           int64_t n, int n_threads,
                           int64_t* hist_out /* [1025] */) {
    if (n <= 0) { for (int i = 0; i <= 1024; ++i) hist_out[i] = 0; return 0; }
    std::vector<uint64_t> hb(n);
    std::vector<int64_t> pb(n);
    std::vector<int8_t> sb(n);
    uint64_t* hs = h;  int64_t* ps = pos;  int8_t* ss = strand;
    uint64_t* hd = hb.data(); int64_t* pd = pb.data(); int8_t* sd = sb.data();
    int nt = std::max(1, std::min(n_threads, 8));
    std::vector<std::vector<int64_t>> hist(nt,
                                           std::vector<int64_t>(65536, 0));
    for (int pass = 0; pass < 4; ++pass) {
        int shift = 16 * pass;
        int64_t per = (n + nt - 1) / nt;
        {
            std::vector<std::thread> ts;
            for (int t = 0; t < nt; ++t) {
                int64_t lo = t * per, hi = std::min(n, lo + per);
                std::fill(hist[t].begin(), hist[t].end(), 0);
                if (lo < hi)
                    ts.emplace_back([&, t, lo, hi, shift]() {
                        auto& hh = hist[t];
                        for (int64_t i = lo; i < hi; ++i)
                            ++hh[(hs[i] >> shift) & 0xFFFF];
                    });
            }
            for (auto& th : ts) th.join();
        }
        // exclusive prefix over (bucket, thread)
        int64_t sum = 0;
        for (int b = 0; b < 65536; ++b)
            for (int t = 0; t < nt; ++t) {
                int64_t c = hist[t][b];
                hist[t][b] = sum;
                sum += c;
            }
        {
            std::vector<std::thread> ts;
            for (int t = 0; t < nt; ++t) {
                int64_t lo = t * per, hi = std::min(n, lo + per);
                if (lo < hi)
                    ts.emplace_back([&, t, lo, hi, shift]() {
                        auto& hh = hist[t];
                        for (int64_t i = lo; i < hi; ++i) {
                            int64_t d = hh[(hs[i] >> shift) & 0xFFFF]++;
                            hd[d] = hs[i];
                            pd[d] = ps[i];
                            sd[d] = ss[i];
                        }
                    });
            }
            for (auto& th : ts) th.join();
        }
        std::swap(hs, hd);
        std::swap(ps, pd);
        std::swap(ss, sd);
    }
    // 4 passes = even count, data is back in the caller's buffers
    // run-length histogram
    for (int i = 0; i <= 1024; ++i) hist_out[i] = 0;
    int64_t run = 1;
    for (int64_t i = 1; i <= n; ++i) {
        if (i == n || h[i] != h[i - 1]) {
            ++hist_out[std::min<int64_t>(run, 1024)];
            run = 1;
        } else {
            ++run;
        }
    }
    return 0;
}

// Drop minimizers whose hash occurs more than max_occ times (the minimap2
// -f high-frequency filter); in-place compaction over the sorted table.
// Returns the new count.
int64_t cap_occurrences_c(uint64_t* h, int64_t* pos, int8_t* strand,
                          int64_t n, int64_t max_occ) {
    int64_t out = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t j = i;
        while (j < n && h[j] == h[i]) ++j;
        if (j - i <= max_occ) {
            if (out != i) {
                std::memmove(h + out, h + i, (size_t)(j - i) * 8);
                std::memmove(pos + out, pos + i, (size_t)(j - i) * 8);
                std::memmove(strand + out, strand + i, (size_t)(j - i));
            }
            out += j - i;
        }
        i = j;
    }
    return out;
}

// Bucketed sorted-hash range lookup (index/minimizer.py::MinimizerIndex.lookup).
// bucket_start has n_buckets+1 entries over hash >> shift.
void lookup_range_c(const uint64_t* hashes, int64_t M,
                    const int64_t* bucket_start, int64_t n_buckets, int shift,
                    const uint64_t* q, int64_t nq,
                    int64_t* lo_out, int64_t* hi_out) {
    for (int64_t i = 0; i < nq; ++i) {
        uint64_t h = q[i];
        int64_t b = (int64_t)(h >> shift);
        if (b >= n_buckets) b = n_buckets - 1;
        const uint64_t* s = hashes + bucket_start[b];
        const uint64_t* e = hashes + bucket_start[b + 1];
        const uint64_t* l = std::lower_bound(s, e, h);
        const uint64_t* u = std::upper_bound(l, e, h);
        lo_out[i] = l - hashes;
        hi_out[i] = u - hashes;
    }
}

// Expand (l, cnt) hit ranges into packed hit arrays for the sharded
// collective's answer frames (parallel/shard_index._lookup_distributed):
// out_pos[ooff[i] .. ooff[i]+cnt[i]) = pos[l[i] .. l[i]+cnt[i]) (as u32
// when pos_u32, else i64), same for strand.  The numpy reference path
// (np.repeat + fancy gather + astype) is memory-bound on multi-MB
// temporaries; this writes each destination byte exactly once.
void gather_hits_c(const int64_t* pos, const int8_t* strand,
                   const int64_t* l, const int64_t* cnt,
                   const int64_t* ooff, int64_t m, int pos_u32,
                   void* out_pos, int8_t* out_strand, int n_threads) {
    auto work = [&](int64_t qlo, int64_t qhi) {
        for (int64_t i = qlo; i < qhi; ++i) {
            int64_t src = l[i], dst = ooff[i], n = cnt[i];
            if (pos_u32) {
                uint32_t* op = (uint32_t*)out_pos + dst;
                for (int64_t j = 0; j < n; ++j)
                    op[j] = (uint32_t)pos[src + j];
            } else {
                memcpy((int64_t*)out_pos + dst, pos + src,
                       (size_t)n * sizeof(int64_t));
            }
            memcpy(out_strand + dst, strand + src, (size_t)n);
        }
    };
    if (n_threads <= 1 || m < 1 << 13) { work(0, m); return; }
    std::vector<std::thread> ts;
    int64_t per = (m + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = std::min(m, lo + per);
        if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
}

// Receive-side scatter: place each answered query's hit run at its slot
// in the per-call hit table (dst_pos[dlo[idx[i]] ...] = ppos[soff[i] ...]).
void scatter_hits_c(const int64_t* ppos, const int8_t* pstr,
                    const int32_t* idx, const int64_t* cnt,
                    const int64_t* soff, int64_t m,
                    const int64_t* dlo, int64_t* dst_pos,
                    int8_t* dst_str, int n_threads) {
    auto work = [&](int64_t qlo, int64_t qhi) {
        for (int64_t i = qlo; i < qhi; ++i) {
            int64_t n = cnt[i], s = soff[i], d = dlo[idx[i]];
            memcpy(dst_pos + d, ppos + s, (size_t)n * sizeof(int64_t));
            memcpy(dst_str + d, pstr + s, (size_t)n);
        }
    };
    if (n_threads <= 1 || m < 1 << 13) { work(0, m); return; }
    std::vector<std::thread> ts;
    int64_t per = (m + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = std::min(m, lo + per);
        if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
}

// Threaded variant: query ranges are independent, outputs strided.
void lookup_range_mt_c(const uint64_t* hashes, int64_t M,
                       const int64_t* bucket_start, int64_t n_buckets,
                       int shift, const uint64_t* q, int64_t nq,
                       int64_t* lo_out, int64_t* hi_out, int n_threads) {
    if (n_threads <= 1 || nq < 1 << 14) {
        lookup_range_c(hashes, M, bucket_start, n_buckets, shift, q, nq,
                       lo_out, hi_out);
        return;
    }
    std::vector<std::thread> ts;
    int64_t per = (nq + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = std::min(nq, lo + per);
        if (lo < hi)
            ts.emplace_back([=] {
                lookup_range_c(hashes, M, bucket_start, n_buckets, shift,
                               q + lo, hi - lo, lo_out + lo, hi_out + lo);
            });
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"

// ------------------------------------------------ terminal-exon rescue
// One pass over a batch's extended candidates that places large terminal
// soft clips as spliced exons: align/aligner.py
// SpliceAligner._rescue_terminal_exons, the same records bit for bit.
namespace {

constexpr int RESCUE_OP_M = 0, RESCUE_OP_I = 1, RESCUE_OP_D = 2,
              RESCUE_OP_N = 3, RESCUE_OP_S = 4;

// The index as the rescue reads it: n bucketed hash tables, a query hash
// routed to table hash % n (a sharded index's routing; a plain index is
// one table), each table's ranges offset by its base into pos / strand.
// Table pointers travel as int64 addresses; a table with m == 0 answers
// nothing.
struct RescueIndex {
    int n;
    const int64_t* hashes;
    const int64_t* m;
    const int64_t* bstart;
    const int64_t* nb;
    const int32_t* shift;
    const int64_t* base;
    const int64_t* pos;
    const int8_t* strand;
};

struct RescueScratch {
    std::vector<uint64_t> h;
    std::vector<int64_t> qp;
    std::vector<int8_t> qs;
    std::vector<int64_t> lo, len, end;   // a query's bound, range left, end
    std::vector<int32_t> tab;
    std::vector<std::pair<int64_t, int64_t>> hits;   // (diagonal, qpos)
    std::vector<int32_t> lops, rops;
    std::vector<uint8_t> rc;
    std::vector<std::pair<int32_t, int64_t>> ops, tmp;
};

// `_seed_clip`: the clip's minimizers looked up, hits kept for seeds of 1
// to 16 places on the clip's strand inside [lo_g, hi_g); the diagonal with
// the most hits (the smallest of a tie), if it has two or more.  Gives the
// diagonal and the smallest and largest clip position on it.
//
// The lookups are lookup_range_c's bucketed lower bounds, run in lockstep
// over the clip's queries (one probe of each a pass, the next probes
// prefetched): on a whole-genome table nearly every probe misses the
// caches and the TLB, and a clip has hundreds of queries, so their misses
// overlap instead of following one another.  An equal run is then counted
// up to 17 entries, enough to drop the seeds of more than 16 places.
bool rescue_seed_clip(const RescueIndex& X, const uint8_t* clip, int64_t c,
                      int k, int w, int64_t lo_g, int64_t hi_g,
                      RescueScratch& S, int64_t* diag, int64_t* qmin,
                      int64_t* qmax) {
    S.h.resize((size_t)c);
    S.qp.resize((size_t)c);
    S.qs.resize((size_t)c);
    const int64_t n = extract_minimizers_c(clip, c, k, w, S.h.data(),
                                           S.qp.data(), S.qs.data());
    S.lo.resize((size_t)n);
    S.len.resize((size_t)n);
    S.end.resize((size_t)n);
    S.tab.resize((size_t)n);
    auto hashes_of = [&](int t) {
        return (const uint64_t*)(uintptr_t)X.hashes[t];
    };
    // each query's table and bucket; the bucket starts prefetched
    for (int64_t j = 0; j < n; ++j) {
        uint64_t hv = S.h[(size_t)j];
        int t = (int)(hv % (uint64_t)X.n);
        S.tab[(size_t)j] = t;
        if (X.m[t] <= 0) { S.len[(size_t)j] = -1; continue; }
        int64_t b = (int64_t)(hv >> X.shift[t]);
        if (b >= X.nb[t]) b = X.nb[t] - 1;
        S.lo[(size_t)j] = b;
        S.len[(size_t)j] = 0;
        __builtin_prefetch((const int64_t*)(uintptr_t)X.bstart[t] + b);
    }
    // the buckets' ranges; their middles prefetched
    for (int64_t j = 0; j < n; ++j) {
        if (S.len[(size_t)j] < 0) continue;
        int t = S.tab[(size_t)j];
        const int64_t* bs = (const int64_t*)(uintptr_t)X.bstart[t];
        int64_t b = S.lo[(size_t)j];
        S.lo[(size_t)j] = bs[b];
        S.end[(size_t)j] = bs[b + 1];
        S.len[(size_t)j] = bs[b + 1] - bs[b];
        __builtin_prefetch(hashes_of(t) + bs[b] + (S.len[(size_t)j] >> 1));
    }
    // lower bounds, one probe a query a pass
    for (bool more = true; more;) {
        more = false;
        for (int64_t j = 0; j < n; ++j) {
            int64_t len = S.len[(size_t)j];
            if (len <= 0) continue;
            const uint64_t* hs = hashes_of(S.tab[(size_t)j]);
            int64_t half = len >> 1, probe = S.lo[(size_t)j] + half;
            if (hs[probe] < S.h[(size_t)j]) {
                S.lo[(size_t)j] = probe + 1;
                len -= half + 1;
            } else {
                len = half;
            }
            S.len[(size_t)j] = len;
            if (len > 0) {
                __builtin_prefetch(hs + S.lo[(size_t)j] + (len >> 1));
                more = true;
            }
        }
    }
    // equal runs of 1 to 16 entries; their places and strands prefetched
    for (int64_t j = 0; j < n; ++j) {
        if (S.len[(size_t)j] < 0) continue;
        int t = S.tab[(size_t)j];
        const uint64_t* hs = hashes_of(t);
        int64_t lo = S.lo[(size_t)j], cnt = 0;
        while (cnt <= 16 && lo + cnt < S.end[(size_t)j] &&
               hs[lo + cnt] == S.h[(size_t)j])
            ++cnt;
        if (cnt == 0 || cnt > 16) { S.len[(size_t)j] = -1; continue; }
        S.len[(size_t)j] = cnt;
        S.lo[(size_t)j] = lo + X.base[t];
        __builtin_prefetch(X.pos + S.lo[(size_t)j]);
        __builtin_prefetch(X.strand + S.lo[(size_t)j]);
    }
    S.hits.clear();
    for (int64_t j = 0; j < n; ++j) {
        if (S.len[(size_t)j] < 0) continue;
        int64_t lo = S.lo[(size_t)j];
        for (int64_t e = lo; e < lo + S.len[(size_t)j]; ++e) {
            if (X.strand[e] != S.qs[(size_t)j]) continue;
            int64_t gp = X.pos[e];
            if (gp >= lo_g && gp < hi_g)
                S.hits.emplace_back(gp - S.qp[(size_t)j], S.qp[(size_t)j]);
        }
    }
    if (S.hits.empty()) return false;
    std::sort(S.hits.begin(), S.hits.end());
    size_t best = 0, best_n = 0;
    for (size_t a = 0; a < S.hits.size();) {
        size_t b = a;
        while (b < S.hits.size() && S.hits[b].first == S.hits[a].first) ++b;
        if (b - a > best_n) { best = a; best_n = b - a; }
        a = b;
    }
    if (best_n < 2) return false;
    *diag = S.hits[best].first;
    *qmin = S.hits[best].second;
    *qmax = S.hits[best + best_n - 1].second;
    return true;
}

inline int64_t rescue_mismatches(const uint8_t* a, const uint8_t* b,
                                 int64_t n) {
    int64_t mm = 0;
    for (int64_t t = 0; t < n; ++t) mm += a[t] != b[t];
    return mm;
}

// mismatches inside the M runs of `ops` (n runs) walked from (qi, gi);
// advances qi and gi
int64_t rescue_run_mismatches(const uint8_t* codes, const uint8_t* ref,
                              const int32_t* ops, int n, int64_t* qi,
                              int64_t* gi) {
    int64_t gm = 0;
    for (int r = 0; r < n; ++r) {
        int op = ops[2 * r];
        int64_t l = ops[2 * r + 1];
        if (op == RESCUE_OP_M) {
            gm += rescue_mismatches(codes + *qi, ref + *gi, l);
            *qi += l; *gi += l;
        } else if (op == RESCUE_OP_I) {
            *qi += l;
        } else {
            *gi += l;
        }
    }
    return gm;
}

inline int64_t rescue_indels(const int32_t* ops, int n) {
    int64_t s = 0;
    for (int r = 0; r < n; ++r)
        if (ops[2 * r] == RESCUE_OP_I || ops[2 * r] == RESCUE_OP_D)
            s += ops[2 * r + 1];
    return s;
}

// append (op, l), merged into the last run when it has the same op
inline void rescue_fold(std::vector<std::pair<int32_t, int64_t>>& ops,
                        int op, int64_t l) {
    if (!ops.empty() && ops.back().first == op) ops.back().second += l;
    else ops.emplace_back(op, l);
}

}  // namespace

extern "C" {

// The terminal-exon rescue of every candidate with rc_in == 0, in place
// on the extension's outputs (extend_chain_batch_c's or
// assemble_ops_batch_c's: ops at ops_io[2 * i * ops_stride], n_ops_io[i]
// runs).  A candidate whose unfiltered first or last run is a soft clip of
// at least k + w + 4 bases has that clip seeded against the index
// (rescue_seed_clip) within max_intron of its alignment edge, the leading
// clip first; a colinear block found there is joined by
// refine_splice_indel_c (band B) when the junction scores above 0 and the
// exon's mismatches are at most a quarter of it.  A placed clip rewrites
// the candidate's ops, pos, ed, nmatch and vote.  flags_out[i]: clips
// seeded (bits 0-1), clips placed (bits 2-3), and bit 4 when the
// rewritten ops would not fit ops_stride runs, in which case nothing of
// the candidate is written.  Threaded over the candidates that have such a
// clip; reads of strand 1 are reverse-complemented as the extension does.
int rescue_terminal_batch_c(
    const uint8_t* reads, const int64_t* read_offs,
    const uint8_t* ref, int64_t ref_len,
    const int64_t* chrom_offs, int n_chrom,
    const int32_t* cand_read, const int8_t* cand_strand,
    int n_tab, const int64_t* tab_hashes, const int64_t* tab_m,
    const int64_t* tab_bstart, const int64_t* tab_nb,
    const int32_t* tab_shift, const int64_t* tab_base,
    const int64_t* idx_pos, const int8_t* idx_strand,
    int k, int w, int64_t max_intron, int min_intron_len, int B,
    int n_cand, int ops_stride, int n_threads, const int32_t* rc_in,
    int64_t* pos_io, int32_t* ops_io, int32_t* n_ops_io, int64_t* ed_io,
    int64_t* nmatch_io, int32_t* vote_io, int8_t* flags_out) {
    const RescueIndex X{n_tab, tab_hashes, tab_m, tab_bstart, tab_nb,
                        tab_shift, tab_base, idx_pos, idx_strand};
    const int64_t min_clip = k + w + 4;
    std::vector<int> todo;
    for (int i = 0; i < n_cand; ++i) {
        flags_out[i] = 0;
        int n0 = n_ops_io[i];
        if (rc_in[i] != 0 || n0 <= 0) continue;
        const int32_t* in = ops_io + (int64_t)i * 2 * ops_stride;
        if ((in[0] == RESCUE_OP_S && in[1] >= min_clip) ||
            (in[2 * (n0 - 1)] == RESCUE_OP_S &&
             in[2 * (n0 - 1) + 1] >= min_clip))
            todo.push_back(i);
    }

    auto one = [&](int i, RescueScratch& S) {
        int32_t* io = ops_io + (int64_t)i * 2 * ops_stride;
        S.ops.clear();
        for (int r = 0; r < n_ops_io[i]; ++r)
            S.ops.emplace_back(io[2 * r], (int64_t)io[2 * r + 1]);
        const uint8_t* codes = reads + read_offs[cand_read[i]];
        int64_t L = read_offs[cand_read[i] + 1] - read_offs[cand_read[i]];
        if (cand_strand[i]) {
            S.rc.resize((size_t)L);
            for (int64_t t = 0; t < L; ++t) {
                uint8_t c = codes[L - 1 - t];
                S.rc[(size_t)t] = c < 4 ? (uint8_t)(3 - c) : c;
            }
            codes = S.rc.data();
        }
        int64_t pos = pos_io[i], ed = ed_io[i], nm = nmatch_io[i];
        int64_t vote = vote_io[i];
        const int64_t* ub = std::upper_bound(chrom_offs,
                                             chrom_offs + n_chrom + 1, pos);
        int tc = (int)(ub - chrom_offs) - 1;
        const int64_t chrom_lo = chrom_offs[tc], chrom_hi = chrom_offs[tc + 1];
        int seeded = 0, placed = 0;
        int64_t d, qmin, qmax, ilen;
        int32_t ln, rn, v;
        double score;

        // ---- leading clip
        if (S.ops[0].first == RESCUE_OP_S && S.ops[0].second >= min_clip) {
            int64_t c = S.ops[0].second;
            ++seeded;
            if (rescue_seed_clip(X, codes, c, k, w,
                                 std::max(chrom_lo, pos - max_intron), pos,
                                 S, &d, &qmin, &qmax)) {
                int64_t exon_g0 = d, exon_len0 = qmax + k;
                int64_t gap_q = c - exon_len0;
                int64_t left_end_g = exon_g0 + exon_len0;
                int cap = (int)gap_q + 2 * B + 4;
                if (gap_q >= 0 &&
                    pos - left_end_g - gap_q >= min_intron_len &&
                    exon_g0 >= chrom_lo) {
                    S.lops.resize(2 * (size_t)cap);
                    S.rops.resize(2 * (size_t)cap);
                    if (refine_splice_indel_c(
                            codes + exon_len0, (int)gap_q, ref, ref_len,
                            left_end_g, pos, B, min_intron_len, 0, 0,
                            S.lops.data(), &ln, S.rops.data(), &rn, &ilen,
                            &v, &score) == 0 && score > 0) {
                        int64_t mism = rescue_mismatches(
                            codes, ref + exon_g0, exon_len0);
                        if (mism <= 0.25 * exon_len0) {
                            // the exon, the junction's runs and the intron
                            // as they come; the rest folded onto them
                            S.tmp.clear();
                            S.tmp.emplace_back(RESCUE_OP_M, exon_len0);
                            for (int r = 0; r < ln; ++r)
                                S.tmp.emplace_back(S.lops[2 * r],
                                                   S.lops[2 * r + 1]);
                            S.tmp.emplace_back(RESCUE_OP_N, ilen);
                            for (int r = 0; r < rn; ++r)
                                S.tmp.emplace_back(S.rops[2 * r],
                                                   S.rops[2 * r + 1]);
                            for (size_t r = 1; r < S.ops.size(); ++r)
                                rescue_fold(S.tmp, S.ops[r].first,
                                            S.ops[r].second);
                            S.ops.swap(S.tmp);
                            pos = exon_g0;
                            int64_t qi = exon_len0, gi = left_end_g;
                            int64_t gm = rescue_run_mismatches(
                                codes, ref, S.lops.data(), ln, &qi, &gi);
                            gi += ilen;
                            gm += rescue_run_mismatches(
                                codes, ref, S.rops.data(), rn, &qi, &gi);
                            ed += mism + gm +
                                  rescue_indels(S.lops.data(), ln) +
                                  rescue_indels(S.rops.data(), rn);
                            nm += exon_len0 - mism;
                            vote += v;
                            ++placed;
                        }
                    }
                }
            }
        }
        // ---- trailing clip, on the ops as the lead left them
        if (!S.ops.empty() && S.ops.back().first == RESCUE_OP_S &&
            S.ops.back().second >= min_clip) {
            int64_t c = S.ops.back().second;
            int64_t qstart = L - c;
            int64_t ref_end = pos;
            for (auto& o : S.ops)
                if (o.first == RESCUE_OP_M || o.first == RESCUE_OP_D ||
                    o.first == RESCUE_OP_N)
                    ref_end += o.second;
            ++seeded;
            if (rescue_seed_clip(X, codes + qstart, c, k, w, ref_end,
                                 std::min(chrom_hi, ref_end + max_intron),
                                 S, &d, &qmin, &qmax)) {
                int64_t exon_gs = d, exon_q0 = qmin;
                int64_t exon_len0 = c - exon_q0;
                int cap = (int)exon_q0 + 2 * B + 4;
                if ((exon_gs + exon_q0) - ref_end >= min_intron_len &&
                    exon_gs + c <= chrom_hi) {
                    S.lops.resize(2 * (size_t)cap);
                    S.rops.resize(2 * (size_t)cap);
                    int64_t gs = exon_gs + exon_q0;
                    if (refine_splice_indel_c(
                            codes + qstart, (int)exon_q0, ref, ref_len,
                            ref_end, gs, B, min_intron_len, 0, 0,
                            S.lops.data(), &ln, S.rops.data(), &rn, &ilen,
                            &v, &score) == 0 && score > 0) {
                        int64_t mism = rescue_mismatches(
                            codes + qstart + exon_q0, ref + gs, exon_len0);
                        if (mism <= 0.25 * exon_len0) {
                            S.ops.pop_back();
                            for (int r = 0; r < ln; ++r)
                                rescue_fold(S.ops, S.lops[2 * r],
                                            S.lops[2 * r + 1]);
                            rescue_fold(S.ops, RESCUE_OP_N, ilen);
                            for (int r = 0; r < rn; ++r)
                                rescue_fold(S.ops, S.rops[2 * r],
                                            S.rops[2 * r + 1]);
                            rescue_fold(S.ops, RESCUE_OP_M, exon_len0);
                            int64_t qi = qstart, gi = ref_end;
                            int64_t gm = rescue_run_mismatches(
                                codes, ref, S.lops.data(), ln, &qi, &gi);
                            // the right flank ends at gs: walk it from its
                            // start
                            int64_t r_ref = 0;
                            for (int r = 0; r < rn; ++r)
                                if (S.rops[2 * r] == RESCUE_OP_M ||
                                    S.rops[2 * r] == RESCUE_OP_D)
                                    r_ref += S.rops[2 * r + 1];
                            gi = gs - r_ref;
                            gm += rescue_run_mismatches(
                                codes, ref, S.rops.data(), rn, &qi, &gi);
                            ed += mism + gm +
                                  rescue_indels(S.lops.data(), ln) +
                                  rescue_indels(S.rops.data(), rn);
                            nm += exon_len0 - mism;
                            vote += v;
                            ++placed;
                        }
                    }
                }
            }
        }
        int8_t f = (int8_t)(seeded | (placed << 2));
        if (placed) {
            if ((int64_t)S.ops.size() > ops_stride) {
                f |= 16;
            } else {
                for (size_t r = 0; r < S.ops.size(); ++r) {
                    io[2 * r] = S.ops[r].first;
                    io[2 * r + 1] = (int32_t)S.ops[r].second;
                }
                n_ops_io[i] = (int32_t)S.ops.size();
                pos_io[i] = pos;
                ed_io[i] = ed;
                nmatch_io[i] = nm;
                vote_io[i] = (int32_t)vote;
            }
        }
        flags_out[i] = f;
    };

    int n_work = (int)todo.size();
    int nt = std::max(1, std::min(n_threads, n_work));
    std::atomic<int> next(0);
    auto work = [&]() {
        RescueScratch S;
        for (int t; (t = next.fetch_add(1)) < n_work;) one(todo[t], S);
    };
    if (nt <= 1) {
        work();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) ts.emplace_back(work);
        for (auto& th : ts) th.join();
    }
    return 0;
}

}  // extern "C"

extern "C" {

// Hamming verify of (read_i, pos) candidate pairs against the combined
// buffer; reads are concatenated with an offsets table.
void hamming_pairs_c(const uint8_t* buf, int64_t n,
                     const uint8_t* reads, const int64_t* read_off,
                     const int32_t* cand_read, const int64_t* cand_pos,
                     int64_t n_cand, int32_t* out_mm) {
    for (int64_t i = 0; i < n_cand; ++i) {
        int64_t ri = cand_read[i];
        int64_t off = read_off[ri];
        int64_t L = read_off[ri + 1] - off;
        int64_t p = cand_pos[i];
        if (p < 0 || p + L > n) { out_mm[i] = 1 << 30; continue; }
        const uint8_t* a = buf + p;
        const uint8_t* b = reads + off;
        int mm = 0;
        for (int64_t t = 0; t < L; ++t) mm += (a[t] != b[t]);
        out_mm[i] = mm;
    }
}

}  // extern "C"

extern "C" {

// Splice-site classification of one bam transcript vs one annotation
// transcript (transcript/classify.py::check_splice_site, itself a faithful
// port of reference update_gtf.c:717-779).  Returns 0 (no known site),
// 1 (known: all bam sites identical), 2 (has known site); clears
// novel_site/exon/junction flags in place.
//
// ref_compat=0 (default semantics): annotation acceptors are matched
// against the bam transcript's true acceptor sites bs[j+1].
// ref_compat=1 replicates the reference's acceptor off-by-one bit-for-bit
// (update_gtf.c:746 compares exon[j].start for j in 0..bn-2, i.e. the
// transcript start plus all-but-the-last acceptor, and clears flag 2j+1
// for the j it matched) — see ARCHITECTURE.md §5; verified against the
// compiled reference oracle in tests/test_reference_oracle.py.
int check_splice_site_c(const int32_t* bs, const int32_t* be, int bn,
                        const int32_t* as_, const int32_t* ae, int an,
                        int64_t bstart, int64_t bend,
                        int64_t astart, int64_t aend, int dis,
                        uint8_t* novel_site_flag,
                        uint8_t* novel_exon_flag,
                        uint8_t* novel_junction_flag,
                        int ref_compat) {
    int64_t ovs = std::max(bstart, astart);
    int64_t ove = std::min(bend, aend);
    int bam_ovlp = 0, identical = 0;
    for (int i = 0; i < bn - 1; ++i) {
        if (be[i] >= ovs && be[i] <= ove) ++bam_ovlp;
        if (bs[i + 1] >= ovs && bs[i + 1] <= ove) ++bam_ovlp;
    }
    for (int i = 0; i < an - 1; ++i) {
        if (ae[i] >= ovs && ae[i] <= ove) {
            for (int j = 0; j < bn - 1; ++j) {
                if (std::abs((int64_t)ae[i] - be[j]) <= dis) {
                    ++identical;
                    novel_site_flag[2 * j] = 0;
                }
            }
        }
        if (as_[i + 1] >= ovs && as_[i + 1] <= ove) {
            for (int j = 0; j < bn - 1; ++j) {
                int64_t bacc = ref_compat ? (int64_t)bs[j] : (int64_t)bs[j + 1];
                if (std::abs((int64_t)as_[i + 1] - bacc) <= dis) {
                    ++identical;
                    novel_site_flag[2 * j + 1] = 0;
                }
            }
        }
    }
    for (int i = 0; i < an; ++i)
        for (int j = 0; j < bn; ++j)
            if (std::abs((int64_t)as_[i] - bs[j]) <= dis &&
                std::abs((int64_t)ae[i] - be[j]) <= dis)
                novel_exon_flag[j] = 0;
    for (int i = 0; i < an - 1; ++i)
        for (int j = 0; j < bn - 1; ++j)
            if (std::abs((int64_t)ae[i] - be[j]) <= dis &&
                std::abs((int64_t)as_[i + 1] - bs[j + 1]) <= dis)
                novel_junction_flag[j] = 0;
    int bam_all = (bn - 1) * 2;
    if (bam_all == bam_ovlp && bam_ovlp == identical) return 1;
    if (identical > 0) return 2;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming SAM-text filter (transcript/filter.py::filter_alignments +
// gtf_filter, faithful to reference bam_filter.c:61-159).  Scans the whole
// SAM buffer, applies the coverage/identity/rm-overlap gates and the
// per-qname best/second-best selection, and returns the byte spans of the
// KEPT alignment lines; the (few) kept lines are re-parsed host-side.
// ---------------------------------------------------------------------------

#include <string>
#include <unordered_map>

extern "C" {

namespace lrflt {
struct Rec {  // one line that passed the per-line gates (pass A)
    int64_t off, len, tid, pos, score;
    int64_t qoff, qlen;
    int intron;
};
}  // namespace lrflt

int64_t filter_sam_c(const char* buf, int64_t n,
                     double cov_rate, double map_qual, double sec_rat,
                     int min_intron_n,
                     // rm intervals per target id (sorted by tid asc like the
                     // reference's read order); -1 tid entries are ignored
                     const int64_t* rm_tid, const int64_t* rm_start,
                     const int64_t* rm_end, int64_t rm_n,
                     int64_t* keep_off, int64_t* keep_len,
                     int64_t* keep_tid, int64_t* keep_pos, int64_t cap,
                     int n_threads) {
    // pass 1: header @SQ order -> tid map
    std::unordered_map<std::string, int64_t> tid_of;
    int64_t pos = 0;
    int64_t next_tid = 0;
    while (pos < n && buf[pos] == '@') {
        int64_t eol = pos;
        while (eol < n && buf[eol] != '\n') ++eol;
        if (eol - pos > 4 && std::memcmp(buf + pos, "@SQ", 3) == 0) {
            // find SN:
            for (int64_t t = pos; t + 3 < eol; ++t) {
                if (buf[t] == 'S' && buf[t + 1] == 'N' && buf[t + 2] == ':' &&
                    (buf[t - 1] == '\t')) {
                    int64_t e = t + 3;
                    while (e < eol && buf[e] != '\t') ++e;
                    tid_of.emplace(std::string(buf + t + 3, e - t - 3),
                                   next_tid++);
                    break;
                }
            }
        }
        pos = eol + 1;
    }

    // per-tid running max-end over the (tid, start)-sorted rm intervals:
    // O(log rm) binary-searched overlap test instead of the reference's
    // per-record linear scan (bam_filter.c:49-59).  tid<0 entries (rm_gtf
    // chromosomes absent from the @SQ header) are dropped here — keeping
    // them would both shift a negative value (UB) and wrongly match query
    // lines whose own RNAME is unheaded (tid -1).
    std::vector<int64_t> rmk_tid, rm_key, rm_maxend;
    rmk_tid.reserve(rm_n); rm_key.reserve(rm_n); rm_maxend.reserve(rm_n);
    for (int64_t i = 0; i < rm_n; ++i) {
        if (rm_tid[i] < 0) continue;
        rmk_tid.push_back(rm_tid[i]);
        rm_key.push_back((int64_t)(((uint64_t)rm_tid[i] << 32) |
                                   ((uint64_t)rm_start[i] & 0xFFFFFFFFULL)));
        int64_t me = rm_end[i];
        if (!rmk_tid.empty() && rmk_tid.size() > 1 &&
            rmk_tid[rmk_tid.size() - 2] == rm_tid[i])
            me = std::max(me, rm_maxend.back());
        rm_maxend.push_back(me);
    }
    auto rm_overlap = [&](int64_t tid, int64_t p0, int64_t rlen) -> bool {
        if (rm_key.empty() || tid < 0) return false;
        int64_t p1 = p0 + rlen - 1;
        int64_t want = (int64_t)(((uint64_t)tid << 32) |
                                 ((uint64_t)(p1 + 1) & 0xFFFFFFFFULL));
        int64_t j = std::upper_bound(rm_key.begin(), rm_key.end(), want - 1)
                    - rm_key.begin();
        if (j == 0 || rmk_tid[j - 1] != tid) return false;
        return rm_maxend[j - 1] >= p0;
    };

    // PASS A (parallel over newline-aligned chunks): the per-line gates —
    // CIGAR walk, coverage/NM math, rm overlap — carry no cross-line
    // state, so each worker emits its kept-candidate lines in order and
    // the concatenation equals the sequential scan exactly.  PASS B (the
    // reference's per-qname best/second-best bookkeeping, bam_filter.c:
    // 130-159) then runs sequentially over just the surviving lines.
    auto parse_range = [&](int64_t lo, int64_t hi,
                           std::vector<lrflt::Rec>& out) {
    int64_t pos = lo;
    while (pos < hi) {
        int64_t eol = pos;
        while (eol < n && buf[eol] != '\n') ++eol;
        int64_t llen = eol - pos;
        // split fields lazily
        const char* f[12];
        int64_t fl[12];
        int nf = 0;
        {
            int64_t s = pos;
            for (int64_t t = pos; t <= eol && nf < 12; ++t) {
                if (t == eol || buf[t] == '\t') {
                    f[nf] = buf + s;
                    fl[nf] = t - s;
                    ++nf;
                    s = t + 1;
                }
            }
        }
        if (nf < 11) { pos = eol + 1; continue; }
        auto atoi_f = [&](int i) -> int64_t {
            int64_t v = 0; bool neg = false; const char* c = f[i];
            int64_t l = fl[i];
            int64_t t = 0;
            if (l && c[0] == '-') { neg = true; t = 1; }
            for (; t < l; ++t) v = v * 10 + (c[t] - '0');
            return neg ? -v : v;
        };
        int64_t flag = atoi_f(1);
        bool keep_line = true;
        int64_t score = 0;
        int intron_n = 0;
        if (flag & 0x4) keep_line = false;  // unmapped
        int64_t tid = -1, p0 = 0, rlen = 0;
        if (keep_line) {
            auto it = tid_of.find(std::string(f[2], fl[2]));
            tid = (it == tid_of.end()) ? -1 : it->second;
            p0 = atoi_f(3) - 1;
            // CIGAR walk: intron count, del len, clip-trimmed qlen, rlen
            int64_t del_len = 0, clip0 = 0, clip1 = 0, qcons = 0;
            int64_t num = 0;
            int op_count = 0;
            char last_op = 0;
            int64_t last_clip = 0;
            for (int64_t t = 0; t < fl[5]; ++t) {
                char c = f[5][t];
                if (c >= '0' && c <= '9') { num = num * 10 + (c - '0'); continue; }
                switch (c) {
                    case 'N': ++intron_n; rlen += num; break;
                    case 'D': del_len += num; rlen += num; break;
                    case 'M': case '=': case 'X':
                        qcons += num; rlen += num; break;
                    case 'I': qcons += num; break;
                    case 'S': case 'H':
                        if (op_count == 0) clip0 = num;
                        last_clip = num;
                        break;
                    default: break;
                }
                ++op_count;
                last_op = c;
                num = 0;
            }
            // reference subtracts the trailing clip only when n_cigar > 1
            // (bam_filter.c:76)
            if (op_count > 1 && (last_op == 'S' || last_op == 'H'))
                clip1 = last_clip;
            else
                clip1 = 0;
            int64_t l_qseq = (fl[9] == 1 && f[9][0] == '*') ? 0 : fl[9];
            int64_t cigar_qlen = l_qseq - clip0;
            // reference: trailing clip subtracted only when n_cigar > 1;
            // a 1-op CIGAR that is a clip keeps it as leading
            cigar_qlen -= clip1;
            double cov = (double)cigar_qlen / (double)l_qseq;  // 0/0 => nan
            if (cov < cov_rate) keep_line = false;  // nan compares false
            if (keep_line) {
                // NM tag
                int64_t ed = 0;
                for (int i = 11; i < nf; ++i) {
                    if (fl[i] > 5 && f[i][0] == 'N' && f[i][1] == 'M' &&
                        f[i][2] == ':') {
                        int64_t v = 0; bool neg = false;
                        for (int64_t t = 5; t < fl[i]; ++t) {
                            if (f[i][t] == '-') { neg = true; continue; }
                            v = v * 10 + (f[i][t] - '0');
                        }
                        ed = neg ? -v : v;
                        break;
                    }
                }
                score = cigar_qlen - ed + del_len;
                if ((double)score < map_qual * (double)cigar_qlen)
                    keep_line = false;
                if (keep_line && rm_n && rm_overlap(tid, p0, rlen))
                    keep_line = false;
            }
        }
        if (keep_line) {
            lrflt::Rec r;
            r.off = pos; r.len = llen; r.tid = tid; r.pos = p0;
            r.score = score; r.intron = intron_n;
            r.qoff = pos; r.qlen = fl[0];
            out.push_back(r);
        }
        pos = eol + 1;
    }
    };  // parse_range

    int T = n_threads < 1 ? 1 : n_threads;
    if (T > 8) T = 8;
    int64_t body = pos;
    std::vector<std::vector<lrflt::Rec>> parts(T);
    if (T == 1 || n - body < (1 << 20)) {
        parse_range(body, n, parts[0]);
    } else {
        std::vector<int64_t> cut(T + 1);
        cut[0] = body;
        cut[T] = n;
        for (int t = 1; t < T; ++t) {
            int64_t c = body + (n - body) * t / T;
            while (c < n && buf[c] != '\n') ++c;
            cut[t] = (c < n) ? c + 1 : n;
        }
        std::vector<std::thread> ths;
        for (int t = 0; t < T; ++t)
            ths.emplace_back([&, t]() {
                parse_range(cut[t], cut[t + 1], parts[t]);
            });
        for (auto& th : ths) th.join();
    }

    // PASS B: exact reference bookkeeping (bam_filter.c:130-159) over the
    // kept-candidate lines, in file order
    int64_t kept = 0;
    const char* lq = nullptr;
    // lql == -1 sentinel: "no group open yet".  Edge (malformed input
    // only, ADVICE r4): a FIRST record with a zero-length QNAME starts
    // its own group here, where a string-compare against an initial
    // empty lqname would have treated it as a continuation — either way
    // it can never be emitted (flush() requires lql > 0), so the two
    // behaviors produce identical output; documented, not "fixed".
    int64_t lql = -1;
    int64_t best_off = -1, best_len = 0;
    int64_t best_tid = -1, best_pos = 0;
    int64_t b_score = 0, s_score = 0;
    int b_intron = 0;

    auto flush = [&]() {
        if (lql > 0 && (double)s_score < sec_rat * (double)b_score &&
            b_intron >= min_intron_n && best_off >= 0 && kept < cap) {
            keep_off[kept] = best_off;
            keep_len[kept] = best_len;
            keep_tid[kept] = best_tid;
            keep_pos[kept] = best_pos;
            ++kept;
        }
    };

    for (int t = 0; t < T; ++t) {
        for (const lrflt::Rec& r : parts[t]) {
            bool same = (lql == r.qlen &&
                         std::memcmp(buf + r.qoff, lq, (size_t)lql) == 0);
            if (same) {
                if (r.score > b_score) {
                    best_off = r.off; best_len = r.len;
                    best_tid = r.tid; best_pos = r.pos;
                    s_score = b_score; b_score = r.score;
                    b_intron = r.intron;
                } else if (r.score > s_score) {
                    s_score = r.score;
                }
            } else {
                flush();
                best_off = r.off; best_len = r.len;
                best_tid = r.tid; best_pos = r.pos;
                b_score = r.score; s_score = 0; b_intron = r.intron;
                lq = buf + r.qoff;
                lql = r.qlen;
            }
        }
    }
    flush();
    return kept;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SAM text -> exon chains (transcript/exon_chain.py::gen_exons semantics,
// faithful to reference bam2gtf.c:31-78): one scan over mapped records,
// emitting per-record exon intervals + strand + qname spans.
// ---------------------------------------------------------------------------

extern "C" {

// Outputs (caller-allocated):
//   rec_tid[i], rec_rev[i], rec_exon_off[i] (into exon arrays),
//   rec_qname_off[i], rec_qname_len[i] (byte spans into buf)
//   exon_start/exon_end: flat 1-based inclusive intervals
// Returns record count; *exon_total receives total exon count.
int64_t sam_to_exons_c(const char* buf, int64_t n,
                       int min_exon, int min_intron, int max_delet,
                       int64_t cap_rec, int64_t cap_exon,
                       int32_t* rec_tid, uint8_t* rec_rev,
                       int64_t* rec_exon_off,
                       int64_t* rec_qname_off, int32_t* rec_qname_len,
                       int32_t* exon_start, int32_t* exon_end,
                       int64_t* exon_total) {
    std::unordered_map<std::string, int64_t> tid_of;
    int64_t pos = 0;
    int64_t next_tid = 0;
    while (pos < n && buf[pos] == '@') {
        int64_t eol = pos;
        while (eol < n && buf[eol] != '\n') ++eol;
        if (eol - pos > 4 && std::memcmp(buf + pos, "@SQ", 3) == 0) {
            for (int64_t t = pos; t + 3 < eol; ++t) {
                if (buf[t] == 'S' && buf[t + 1] == 'N' && buf[t + 2] == ':' &&
                    buf[t - 1] == '\t') {
                    int64_t e = t + 3;
                    while (e < eol && buf[e] != '\t') ++e;
                    tid_of.emplace(std::string(buf + t + 3, e - t - 3),
                                   next_tid++);
                    break;
                }
            }
        }
        pos = eol + 1;
    }

    int64_t nr = 0, ne = 0;
    while (pos < n && nr < cap_rec) {
        int64_t eol = pos;
        while (eol < n && buf[eol] != '\n') ++eol;
        const char* f[12];
        int64_t fl[12];
        int nf = 0;
        int64_t tag_start = -1;
        {
            int64_t s = pos;
            for (int64_t t = pos; t <= eol; ++t) {
                if (t == eol || buf[t] == '\t') {
                    if (nf < 12) { f[nf] = buf + s; fl[nf] = t - s; }
                    ++nf;
                    if (nf == 11) tag_start = t + 1;
                    s = t + 1;
                }
            }
        }
        if (nf < 11) { pos = eol + 1; continue; }
        int64_t flag = 0;
        for (int64_t t = 0; t < fl[1]; ++t) flag = flag * 10 + (f[1][t] - '0');
        if (flag & 0x4) { pos = eol + 1; continue; }  // unmapped skipped
        auto it = tid_of.find(std::string(f[2], fl[2]));
        int32_t tid = (it == tid_of.end()) ? -1 : (int32_t)it->second;
        int64_t p1 = 0;
        for (int64_t t = 0; t < fl[3]; ++t) p1 = p1 * 10 + (f[3][t] - '0');
        // strand: XS tag overrides FLAG (bam2gtf.c:35-37)
        uint8_t is_rev = (flag & 0x10) ? 1 : 0;
        if (tag_start >= 0) {
            for (int64_t t = tag_start; t + 5 <= eol; ++t) {
                if ((t == tag_start || buf[t - 1] == '\t') &&
                    buf[t] == 'X' && buf[t + 1] == 'S' && buf[t + 2] == ':' &&
                    t + 5 < eol) {
                    is_rev = (buf[t + 5] == '+') ? 0 : 1;  // XS:A:+ value
                    break;
                }
            }
        }
        // CIGAR walk (gen_exon)
        int64_t start = p1, end = p1 - 1;
        int64_t num = 0;
        int64_t first_exon = ne;
        auto add_exon = [&](int64_t s, int64_t e) {
            if (ne < cap_exon) {
                exon_start[ne] = (int32_t)s;
                exon_end[ne] = (int32_t)e;
                ++ne;
            }
        };
        for (int64_t t = 0; t < fl[5]; ++t) {
            char c = f[5][t];
            if (c >= '0' && c <= '9') { num = num * 10 + (c - '0'); continue; }
            switch (c) {
                case 'N':
                    if (num >= min_intron) {
                        if (ne == first_exon || (end - start + 1) >= min_exon)
                            add_exon(start, end);
                        start = end + num + 1;
                    }
                    end += num;
                    break;
                case 'D':
                    if (num > max_delet) {
                        if (ne == first_exon || (end - start + 1) >= min_exon)
                            add_exon(start, end);
                        start = end + num + 1;
                    }
                    end += num;
                    break;
                case 'M': case '=': case 'X':
                    end += num;
                    break;
                default:
                    break;  // I/S/H/P consume no reference
            }
            num = 0;
        }
        add_exon(start, end);
        rec_tid[nr] = tid;
        rec_rev[nr] = is_rev;
        rec_exon_off[nr] = first_exon;
        rec_qname_off[nr] = pos;
        rec_qname_len[nr] = (int32_t)fl[0];
        ++nr;
        pos = eol + 1;
    }
    *exon_total = ne;
    return nr;
}

}  // extern "C"

extern "C" {

// Identity/containment check on splice chains
// (transcript/classify.py::check_iden, faithful to reference gtf.c:54-92
// including the dead return-1 path).  Raw-pointer binding.
int check_iden_c(const int32_t* s1, const int32_t* e1, int n1,
                 const int32_t* s2, const int32_t* e2, int n2,
                 int64_t ss_dis, int64_t end_dis) {
    if (n1 == n2) {
        if (std::abs((int64_t)s1[0] - s2[0]) > end_dis) return -1;
        for (int i = 0; i + 1 < n1; ++i) {
            if (std::abs((int64_t)e1[i] - e2[i]) > ss_dis) return -1;
            if (std::abs((int64_t)s1[i + 1] - s2[i + 1]) > ss_dis) return -1;
        }
        if (std::abs((int64_t)e1[n1 - 1] - e2[n2 - 1]) > end_dis) return -1;
        return 0;
    }
    const int32_t *ls, *le, *ss, *se;
    int ln, sn;
    if (n1 > n2) { ls = s1; le = e1; ln = n1; ss = s2; se = e2; sn = n2; }
    else         { ls = s2; le = e2; ln = n2; ss = s1; se = e1; sn = n1; }
    // the reference reads s->exon[1] unconditionally here; its only caller
    // (merge_trans) guarantees both chains are multi-exon.  Make the
    // single-exon containment case explicitly "no match".
    if (sn < 2) return -1;
    if (std::abs((int64_t)ls[0] - ss[0]) > end_dis) return -1;
    int result = -1;
    for (int i = 0; i + 1 < ln; ++i) {
        if (std::abs((int64_t)le[i] - se[0]) <= ss_dis &&
            std::abs((int64_t)ls[i + 1] - ss[1]) <= ss_dis) {
            int m = std::min(ln - 2 - i, sn - 2);
            for (int t = 0; t < m; ++t) {
                if (std::abs((int64_t)le[i + 1 + t] - se[1 + t]) > ss_dis)
                    return -1;
                if (std::abs((int64_t)ls[i + 2 + t] - ss[2 + t]) > ss_dis)
                    return -1;
            }
            result = 2;
            break;
        }
    }
    if (std::abs((int64_t)le[ln - 1] - se[sn - 1]) > end_dis) return -1;
    return result;
}

// SAM text emission from packed record arrays (align/records.py
// RecordBatch.emit_sam; line layout of io/sam.SamWriter.write):
//   qname flag rname pos+1 mapq cigar * 0 0 seq * NM:i: AS:i: NH:i: [XS:A:]
// Sequences are stored once per read as forward codes; seq_rc=1 emits the
// reverse complement.  qname/ref blobs are NUL-separated.  Returns bytes
// written, or -1 when out_cap would overflow.
int64_t format_sam_batch_c(
    const uint8_t* qname_blob, const int64_t* qname_offs,
    const int32_t* flag, const int32_t* tid, const int64_t* pos,
    const int32_t* mapq,
    const uint32_t* cig_buf, const int64_t* cig_offs,
    const uint8_t* seq_buf, const int64_t* seq_offs, const int32_t* seq_id,
    const int8_t* seq_rc,
    const int64_t* nm, const int64_t* as_, const int32_t* nh,
    const int8_t* xs,
    const uint8_t* ref_blob, const int64_t* ref_offs,
    int64_t n, uint8_t* out, int64_t out_cap) {
    static const char OPS[] = "MIDNSHP=X";
    static const char BASE[] = "ACGTN";
    static const char CBASE[] = "TGCAN";
    int64_t o = 0;
    auto put_int = [&](int64_t v) { o = put_i64(out, o, v); };
    auto put = [&](const void* p, int64_t l) {
        std::memcpy(out + o, p, (size_t)l);
        o += l;
    };
    for (int64_t i = 0; i < n; ++i) {
        int64_t ql = qname_offs[i + 1] - qname_offs[i] - 1;
        int64_t nc = cig_offs[i + 1] - cig_offs[i];
        int64_t s0 = seq_offs[seq_id[i]], s1 = seq_offs[seq_id[i] + 1];
        int64_t sl = s1 - s0;
        int64_t rl = (tid[i] >= 0)
            ? ref_offs[tid[i] + 1] - ref_offs[tid[i]] - 1 : 1;
        int64_t need = ql + rl + 12 * nc + sl + 160;
        if (o + need > out_cap) return -1;
        put(qname_blob + qname_offs[i], ql);
        out[o++] = '\t';
        put_int(flag[i]);
        out[o++] = '\t';
        if (tid[i] >= 0) put(ref_blob + ref_offs[tid[i]], rl);
        else out[o++] = '*';
        out[o++] = '\t';
        put_int(pos[i] + 1);
        out[o++] = '\t';
        put_int(mapq[i]);
        out[o++] = '\t';
        if (nc == 0) out[o++] = '*';
        for (int64_t t = cig_offs[i]; t < cig_offs[i + 1]; ++t) {
            put_int((int64_t)(cig_buf[t] >> 4));
            out[o++] = (uint8_t)OPS[cig_buf[t] & 0xF];
        }
        put("\t*\t0\t0\t", 7);
        if (sl == 0) {
            out[o++] = '*';
        } else if (seq_rc[i]) {
            for (int64_t t = s1 - 1; t >= s0; --t) {
                uint8_t c = seq_buf[t];
                out[o++] = (uint8_t)CBASE[c < 4 ? c : 4];
            }
        } else {
            for (int64_t t = s0; t < s1; ++t) {
                uint8_t c = seq_buf[t];
                out[o++] = (uint8_t)BASE[c < 4 ? c : 4];
            }
        }
        put("\t*\tNM:i:", 8);
        put_int(nm[i]);
        put("\tAS:i:", 6);
        put_int(as_[i]);
        put("\tNH:i:", 6);
        put_int(nh[i]);
        if (xs[i]) {
            put("\tXS:A:", 6);
            out[o++] = xs[i] > 0 ? '+' : '-';
        }
        out[o++] = '\n';
    }
    return o;
}

}  // extern "C"

extern "C" {

// GTF text formatting (io/gtf.py::write_read_trans, byte-identical to
// reference print_read_trans gtf.c:607-632): emits transcript + exon lines
// (exons reversed for '-' strand) into one output buffer.  Attribute
// strings are prebuilt host-side (they carry python string data); numbers
// format here — the python f-string path ran ~4 us/line over millions of
// lines.  Returns bytes written, or -1 if out_cap is too small.
int64_t format_gtf_c(
    const uint8_t* chrom_buf, const int64_t* chrom_off,
    const uint8_t* src, int64_t src_len,
    const int32_t* tid, const uint8_t* is_rev,
    const int32_t* start, const int32_t* end, const int32_t* cov,
    const int32_t* es, const int32_t* ee, int64_t ew, const int32_t* en,
    const uint8_t* attr_buf, const int64_t* attr_off,
    int64_t n, uint8_t* out, int64_t out_cap) {
    int64_t o = 0;
    auto put = [&](const uint8_t* p, int64_t l) {
        std::memcpy(out + o, p, (size_t)l);
        o += l;
    };
    auto put_int = [&](int64_t v) { o = put_i64(out, o, v); };
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* chrom = chrom_buf + chrom_off[tid[i]];
        int64_t chrom_len = chrom_off[tid[i] + 1] - chrom_off[tid[i]];
        const uint8_t* attr = attr_buf + attr_off[i];
        int64_t attr_len = attr_off[i + 1] - attr_off[i];
        char strand = is_rev[i] ? '-' : '+';
        int nexon = en[i];
        // worst-case bytes for this transcript's lines
        int64_t need = (int64_t)(nexon + 1) *
                       (chrom_len + src_len + attr_len + 96);
        if (o + need > out_cap) return -1;
        // transcript line
        put(chrom, chrom_len);
        out[o++] = '\t';
        put(src, src_len);
        const char* t1 = "\ttranscript\t";
        put((const uint8_t*)t1, 12);
        put_int(start[i]);
        out[o++] = '\t';
        put_int(end[i]);
        const char* mid = "\t.\t";
        put((const uint8_t*)mid, 3);
        out[o++] = (uint8_t)strand;
        put((const uint8_t*)mid, 3);
        put(attr, attr_len);
        const char* covs = " transcript_cov \"";
        put((const uint8_t*)covs, 17);
        put_int(cov[i]);
        out[o++] = '"';
        out[o++] = ';';
        out[o++] = '\n';
        for (int t = 0; t < nexon; ++t) {
            int j = is_rev[i] ? nexon - 1 - t : t;
            put(chrom, chrom_len);
            out[o++] = '\t';
            put(src, src_len);
            const char* t2 = "\texon\t";
            put((const uint8_t*)t2, 6);
            put_int(es[i * ew + j]);
            out[o++] = '\t';
            put_int(ee[i * ew + j]);
            put((const uint8_t*)mid, 3);
            out[o++] = (uint8_t)strand;
            put((const uint8_t*)mid, 3);
            put(attr, attr_len);
            out[o++] = '\n';
        }
    }
    return o;
}

// Batched order-dependent merge (transcript/merge.py::merge_trans applied
// to a candidate sequence; reference update_gtf.c:98-163): for each
// candidate, backward-scan the kept set T; identical multi-exon chains
// absorb (cov++, terminal-exon extension), contained chains absorb,
// single-exon pairs merge on overlap fraction; misses append into T's
// preallocated arrays (string columns are backfilled host-side in the
// same order).  Returns the new T_n; merged_out[i]=1 when candidate i
// was absorbed.  The python loop paid ~20 us per check_iden crossing
// (826k crossings at 500k-read scale).
int64_t merge_into_batch_c(
    const int32_t* c_es, const int32_t* c_ee, int64_t c_w,
    const int32_t* c_en, const int32_t* c_tid, const uint8_t* c_isrev,
    const int32_t* c_start, const int32_t* c_end, const int32_t* c_cov,
    const int64_t* cand_idx, int64_t n_cand,
    int32_t* T_es, int32_t* T_ee, int64_t T_w,
    int32_t* T_en, int32_t* T_tid, uint8_t* T_isrev,
    int32_t* T_start, int32_t* T_end, int32_t* T_cov,
    int64_t T_n, int64_t T_cap,
    int force_strand, int ss_dis, int end_dis, double se_frac,
    uint8_t* merged_out) {
    for (int64_t t = 0; t < n_cand; ++t) {
        int64_t ci = cand_idx[t];
        const int32_t* es = c_es + ci * c_w;
        const int32_t* ee = c_ee + ci * c_w;
        int en = c_en[ci];
        bool merged = false;
        for (int64_t i = T_n - 1; i >= 0; --i) {
            if (c_tid[ci] > T_tid[i] || c_start[ci] > T_end[i]) break;
            if (force_strand && c_isrev[ci] != T_isrev[i]) continue;
            int Tn_e = T_en[i];
            int32_t* Ts = T_es + i * T_w;
            int32_t* Te = T_ee + i * T_w;
            if (en == 1 && Tn_e == 1) {
                // merge_trans2 (update_gtf.c:122-140)
                int64_t ts = es[0], te = ee[0];
                int64_t Us = Ts[0], Ue = Te[0];
                if (std::abs(ts - Us) > end_dis ||
                    std::abs(te - Ue) > end_dis)
                    continue;
                double frac = 0.0;
                if (!(ts > Ue || Us > te)) {
                    int64_t ov = std::min(te, Ue) - std::max(ts, Us) + 1;
                    int64_t ml = std::min(te - ts + 1, Ue - Us + 1);
                    frac = (double)ov / (double)ml;
                }
                if (frac >= se_frac) {
                    ++T_cov[i];
                    if (ts < Us) { Ts[0] = (int32_t)ts;
                                   T_start[i] = (int32_t)ts; }
                    if (te > Ue) { Te[0] = (int32_t)te;
                                   T_end[i] = (int32_t)te; }
                    merged = true;
                    break;
                }
            } else if (en > 1 && Tn_e > 1) {
                // merge_trans1 (update_gtf.c:98-119)
                int ret = check_iden_c(es, ee, en, Ts, Te, Tn_e,
                                       ss_dis, end_dis);
                if (ret == 0) {
                    ++T_cov[i];
                    if (es[0] < Ts[0]) { Ts[0] = es[0];
                                         T_start[i] = es[0]; }
                    if (ee[en - 1] > Te[Tn_e - 1]) {
                        Te[Tn_e - 1] = ee[en - 1];
                        T_end[i] = ee[en - 1];
                    }
                    merged = true;
                    break;
                }
                if (ret == 2) { merged = true; break; }
            }
        }
        merged_out[t] = merged ? 1 : 0;
        if (!merged) {
            if (T_n >= T_cap) return -1;   // caller must pre-grow
            std::memcpy(T_es + T_n * T_w, es, sizeof(int32_t) * en);
            std::memcpy(T_ee + T_n * T_w, ee, sizeof(int32_t) * en);
            for (int64_t z = en; z < T_w; ++z) {
                T_es[T_n * T_w + z] = 0;
                T_ee[T_n * T_w + z] = 0;
            }
            T_en[T_n] = en;
            T_tid[T_n] = c_tid[ci];
            T_isrev[T_n] = c_isrev[ci];
            T_start[T_n] = c_start[ci];
            T_end[T_n] = c_end[ci];
            T_cov[T_n] = c_cov[ci];
            ++T_n;
        }
    }
    return T_n;
}

// Batched annotation sweep (transcript/classify.py::check_with_anno_trans
// for every bam transcript; reference update_gtf.c:792-835 + 629-696).
// Both transcript sets must be coordinate-sorted.  Runs the merge-join
// cursor, check_full accumulation, single-exon overlap test and the
// splice-site classification (check_splice_site_c) per overlap pair, and
// finalizes the full bit (set_full).  Flags are uint8 views of the python
// bool columns, novel-flag rows are strided 2D views.  ref_anno[bi] gets
// the adopted annotation index or -1 (gene id/name adoption — strings —
// stays host-side).
int classify_batch_c(
    const int32_t* b_es, const int32_t* b_ee, int64_t b_w,
    const int32_t* b_en, const int32_t* b_tid,
    const int32_t* b_start, const int32_t* b_end, int64_t bn_total,
    uint8_t* f_known, uint8_t* f_has_known, uint8_t* f_full,
    uint8_t* f_lfull, uint8_t* f_rfull, uint8_t* f_lnoth, uint8_t* f_rnoth,
    uint8_t* nsf, int64_t nsf_w, uint8_t* nef, int64_t nef_w,
    uint8_t* njf, int64_t njf_w,
    const int32_t* a_es, const int32_t* a_ee, int64_t a_w,
    const int32_t* a_en, const int32_t* a_tid,
    const int32_t* a_start, const int32_t* a_end, int64_t an_total,
    int full_level, int ss_dis, double se_ovlp_frac, int ref_compat,
    int64_t* ref_anno) {
    auto exon_overlap = [](int64_t s1, int64_t e1, int64_t s2, int64_t e2) {
        return !(s1 > e2 || s2 > e1);
    };
    int64_t last_anno_i = 0;
    for (int64_t bi = 0; bi < bn_total; ++bi) {
        const int32_t* bs = b_es + bi * b_w;
        const int32_t* be = b_ee + bi * b_w;
        int bcnt = b_en[bi];
        bool single = bcnt == 1;
        int64_t refa = -1;
        for (int64_t ai = last_anno_i; ai < an_total; ++ai) {
            // comp_trans (update_gtf.c:786-790)
            int cmp;
            if (b_tid[bi] < a_tid[ai] ||
                (b_tid[bi] == a_tid[ai] && b_end[bi] <= a_start[ai]))
                cmp = -1;
            else if (a_tid[ai] < b_tid[bi] ||
                     (a_tid[ai] == b_tid[bi] && a_end[ai] <= b_start[bi]))
                cmp = 1;
            else
                cmp = 0;
            if (cmp < 0) break;
            if (cmp > 0) {
                if (last_anno_i == ai) ++last_anno_i;
                continue;
            }
            const int32_t* as_ = a_es + ai * a_w;
            const int32_t* ae = a_ee + ai * a_w;
            int acnt = a_en[ai];
            // check_full (update_gtf.c:629-681)
            if (!(f_lfull[bi] && f_rfull[bi])) {
                int i = bcnt - 1, j = acnt - 1;
                if (full_level == 1) {
                    if (!f_lfull[bi] && be[0] == ae[0]) f_lfull[bi] = 1;
                    if (!f_rfull[bi] && bs[i] == as_[j]) f_rfull[bi] = 1;
                } else if (full_level == 2) {
                    if (!f_lfull[bi] &&
                        exon_overlap(bs[0], be[0], as_[0], ae[0]))
                        f_lfull[bi] = 1;
                    if (!f_rfull[bi] &&
                        exon_overlap(bs[i], be[i], as_[j], ae[j]))
                        f_rfull[bi] = 1;
                } else if (full_level == 3 || full_level == 4) {
                    if (!f_lfull[bi]) {
                        if (exon_overlap(bs[0], be[0], as_[0], ae[0]))
                            f_lfull[bi] = 1;
                        else {
                            for (int t = 0; t < acnt; ++t)
                                if (bs[0] <= ae[t] && as_[t] <= be[0]) {
                                    f_lnoth[bi] = 0;
                                    break;
                                }
                        }
                    }
                    if (full_level == 3 && !f_rfull[bi]) {
                        if (exon_overlap(bs[i], be[i], as_[j], ae[j]))
                            f_rfull[bi] = 1;
                        else {
                            for (int t = 0; t < acnt; ++t)
                                if (bs[i] <= ae[t] && as_[t] <= be[i]) {
                                    f_rnoth[bi] = 0;
                                    break;
                                }
                        }
                    }
                }
            }
            if (single && acnt == 1) {
                // exon_overlap_frac (update_gtf.c:80-89)
                double frac = 0.0;
                if (!(bs[0] > ae[0] || as_[0] > be[0])) {
                    int64_t ov = std::min<int64_t>(be[0], ae[0]) -
                                 std::max<int64_t>(bs[0], as_[0]) + 1;
                    int64_t ml = std::min<int64_t>(be[0] - bs[0] + 1,
                                                   ae[0] - as_[0] + 1);
                    frac = (double)ov / (double)ml;
                }
                if (frac >= se_ovlp_frac) {
                    refa = ai;
                    f_known[bi] = 1;
                    break;
                }
            } else if (!single && acnt > 1) {
                int ret = check_splice_site_c(
                    bs, be, bcnt, as_, ae, acnt,
                    b_start[bi], b_end[bi], a_start[ai], a_end[ai], ss_dis,
                    nsf + bi * nsf_w, nef + bi * nef_w, njf + bi * njf_w,
                    ref_compat);
                if (ret == 1) {
                    f_known[bi] = 1;
                    refa = ai;
                    break;
                }
                if (ret == 2) {
                    f_has_known[bi] = 1;
                    refa = ai;
                }
            }
        }
        ref_anno[bi] = refa;
        // set_full (update_gtf.c:683-696)
        if (full_level == 5) f_full[bi] = 1;
        else if (full_level == 4) f_full[bi] = f_lfull[bi] || f_lnoth[bi];
        else if (full_level == 3)
            f_full[bi] = (f_lfull[bi] || f_lnoth[bi]) &&
                         (f_rfull[bi] || f_rnoth[bi]);
        else f_full[bi] = f_lfull[bi] && f_rfull[bi];
    }
    return 0;
}

// Per-read 17-column novelty detail formatter (report/summary.py::
// write_bam_detail; reference update_gtf.c:297-419).  String columns
// arrive as concatenated byte blobs + offsets; numeric/flag columns
// format here — the python per-row path cost ~10 s at 500k reads
// (2M join() calls).  Returns bytes written, or -1 on capacity overflow.
int64_t format_detail_c(
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* gid_buf, const int64_t* gid_off,
    const uint8_t* gname_buf, const int64_t* gname_off,
    const uint8_t* chrom_buf, const int64_t* chrom_off,
    const int32_t* tid, const uint8_t* is_rev,
    const uint8_t* known, const uint8_t* has_site,
    const int32_t* en,
    const int32_t* es, const int32_t* ee, int64_t ew,
    const uint8_t* ne_flag, int64_t ne_w,
    const uint8_t* ns_flag, int64_t ns_w,
    const uint8_t* nj_flag, int64_t nj_w,
    const uint8_t* uj_flag, int64_t uj_w,
    int64_t n, uint8_t* out, int64_t out_cap) {
    int64_t o = 0;
    auto put = [&](const uint8_t* p, int64_t l) {
        std::memcpy(out + o, p, (size_t)l);
        o += l;
    };
    auto put_int = [&](int64_t v) { o = put_i64(out, o, v); };
    // flag group: count + comma-joined indices of set flags in [0, win)
    auto put_flags = [&](const uint8_t* flags, int64_t win) {
        int64_t cnt = 0;
        for (int64_t j = 0; j < win; ++j) cnt += flags[j] ? 1 : 0;
        put_int(cnt);
        out[o++] = '\t';
        if (cnt == 0) {
            out[o++] = 'N';
            out[o++] = 'A';
            return;
        }
        bool first = true;
        for (int64_t j = 0; j < win; ++j) {
            if (!flags[j]) continue;
            if (!first) out[o++] = ',';
            first = false;
            put_int(j);
        }
    };
    for (int64_t i = 0; i < n; ++i) {
        int e = en[i];
        int64_t name_l = name_off[i + 1] - name_off[i];
        int64_t gid_l = gid_off[i + 1] - gid_off[i];
        int64_t gname_l = gname_off[i + 1] - gname_off[i];
        int64_t chrom_l = chrom_off[tid[i] + 1] - chrom_off[tid[i]];
        int64_t win_total = (int64_t)e + 4 * (int64_t)(e > 1 ? e - 1 : 0);
        int64_t need = name_l + gid_l + gname_l + chrom_l + 96 +
                       (int64_t)e * 24 + win_total * 13;
        if (o + need > out_cap) return -1;
        put(name_buf + name_off[i], name_l);
        out[o++] = '\t';
        put(chrom_buf + chrom_off[tid[i]], chrom_l);
        out[o++] = '\t';
        out[o++] = is_rev[i] ? '-' : '+';
        out[o++] = '\t';
        out[o++] = known[i] ? '0' : (has_site[i] ? '1' : '2');
        out[o++] = '\t';
        put(gid_buf + gid_off[i], gid_l);
        out[o++] = '\t';
        put(gname_buf + gname_off[i], gname_l);
        out[o++] = '\t';
        put_int(e);
        out[o++] = '\t';
        for (int j = 0; j < e; ++j) {
            if (j) out[o++] = ',';
            put_int(es[i * ew + j]);
        }
        out[o++] = '\t';
        for (int j = 0; j < e; ++j) {
            if (j) out[o++] = ',';
            put_int(ee[i * ew + j]);
        }
        out[o++] = '\t';
        int64_t w_ne = e < (int)ne_w ? e : (int64_t)ne_w;
        put_flags(ne_flag + i * ne_w, w_ne);
        out[o++] = '\t';
        int64_t w_ns = 2 * ((int64_t)e - 1);
        if (w_ns > ns_w) w_ns = ns_w;
        if (w_ns < 0) w_ns = 0;
        put_flags(ns_flag + i * ns_w, w_ns);
        out[o++] = '\t';
        int64_t w_nj = (int64_t)e - 1;
        if (w_nj > nj_w) w_nj = nj_w;
        if (w_nj < 0) w_nj = 0;
        put_flags(nj_flag + i * nj_w, w_nj);
        out[o++] = '\t';
        int64_t w_uj = (int64_t)e - 1;
        if (w_uj > uj_w) w_uj = uj_w;
        if (w_uj < 0) w_uj = 0;
        put_flags(uj_flag + i * uj_w, w_uj);
        // faithful byte quirk (update_gtf.c:404-414): an EMPTY column 16
        // prints "NA\t" (tab kept) while a non-empty index list drops
        // its trailing tab — so zero-unreliable lines end "NA\t\n"
        int64_t uj_cnt = 0;
        for (int64_t j = 0; j < w_uj; ++j) uj_cnt += uj_flag[i * uj_w + j] ? 1 : 0;
        if (uj_cnt == 0) out[o++] = '\t';
        out[o++] = '\n';
    }
    return o;
}

// Compact the ragged per-read minimizer regions written by
// extract_minimizers_batch_c into dense arrays + a read-id column
// (align/batch.py::_batch_minimizers; the numpy repeat + triple gather
// cost ~20 ms per 1500-read batch).  out_off = exclusive prefix of
// per-read counts.
void compact_minimizers_c(
    const uint64_t* oh, const int64_t* op, const int8_t* os,
    const int64_t* read_offs, const int64_t* counts,
    const int64_t* out_off, int64_t n_reads,
    uint64_t* h_out, int64_t* p_out, int8_t* s_out, int32_t* rid_out,
    int n_threads) {
    int nt = std::max(1, std::min(n_threads, 16));
    int64_t per = (n_reads + nt - 1) / nt;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) {
        int64_t r0 = t * per, r1 = std::min(n_reads, r0 + per);
        if (r0 >= r1) continue;
        ts.emplace_back([&, r0, r1]() {
            for (int64_t r = r0; r < r1; ++r) {
                int64_t src = read_offs[r];
                int64_t dst = out_off[r];
                int64_t c = counts[r];
                std::memcpy(h_out + dst, oh + src, c * sizeof(uint64_t));
                std::memcpy(p_out + dst, op + src, c * sizeof(int64_t));
                std::memcpy(s_out + dst, os + src, c * sizeof(int8_t));
                for (int64_t i = 0; i < c; ++i) rid_out[dst + i] = (int32_t)r;
            }
        });
    }
    for (auto& th : ts) th.join();
}

// Anchor expansion + composite sort key (align/batch.py::_batch_anchors):
// for each surviving seed s with index-hit range [lo[s], hi[s]), emit one
// anchor per hit carrying (gpos, xor-strand, read id, strand-adjusted
// query pos) plus the radix key (rid<<52 | strand<<51 | gpos<<19 | qfinal)
// — the numpy repeat/gather/where chain cost ~70 ms per 1500-read batch.
// Threaded over seed ranges; out_off[s] = exclusive prefix of hit counts.
void expand_anchors_c(
    const int64_t* lo, const int64_t* hi, const int64_t* out_off,
    int64_t n_seeds,
    const int64_t* idx_pos, const int8_t* idx_strand,
    const int64_t* qp, const int8_t* qs, const int32_t* rid,
    const int64_t* read_len, int32_t k,
    int64_t* gp_out, int8_t* strand_out, int32_t* rid_out,
    int64_t* qfinal_out, uint64_t* key_out, int build_key,
    int n_threads) {
    int nt = std::max(1, std::min(n_threads, 16));
    int64_t per = (n_seeds + nt - 1) / nt;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) {
        int64_t s0 = t * per, s1 = std::min(n_seeds, s0 + per);
        if (s0 >= s1) continue;
        ts.emplace_back([&, s0, s1]() {
            for (int64_t s = s0; s < s1; ++s) {
                int64_t o = out_off[s];
                int32_t r = rid[s];
                int64_t L = read_len[r];
                for (int64_t j = lo[s]; j < hi[s]; ++j, ++o) {
                    int64_t g = idx_pos[j];
                    int8_t st = (int8_t)(qs[s] ^ idx_strand[j]);
                    int64_t qf = st ? (L - k - qp[s]) : qp[s];
                    gp_out[o] = g;
                    strand_out[o] = st;
                    rid_out[o] = r;
                    qfinal_out[o] = qf;
                    if (build_key)
                        key_out[o] = ((uint64_t)r << 52) |
                                     ((uint64_t)(st & 1) << 51) |
                                     ((uint64_t)g << 19) | (uint64_t)qf;
                }
            }
        });
    }
    for (auto& th : ts) th.join();
}

// BED12 line formatter (pipeline/stages.py bed12 export, the bedtools
// `bamtobed -bed12` role at reference Snakefile:63).  Exon size/start
// lists arrive as ragged int64 arrays; strings as blobs + offsets.
int64_t format_bed12_c(
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* chrom_buf, const int64_t* chrom_off,
    const int32_t* tid, const uint8_t* is_rev, const int32_t* mapq,
    const int64_t* start0, const int64_t* end,
    const int64_t* sizes, const int64_t* rel_starts,
    const int64_t* exon_off,
    int64_t n, uint8_t* out, int64_t out_cap) {
    int64_t o = 0;
    auto put = [&](const uint8_t* p, int64_t l) {
        std::memcpy(out + o, p, (size_t)l);
        o += l;
    };
    auto put_int = [&](int64_t v) { o = put_i64(out, o, v); };
    for (int64_t i = 0; i < n; ++i) {
        int64_t ne = exon_off[i + 1] - exon_off[i];
        int64_t name_l = name_off[i + 1] - name_off[i];
        int64_t chrom_l = chrom_off[tid[i] + 1] - chrom_off[tid[i]];
        if (o + name_l + chrom_l + 120 + ne * 26 > out_cap) return -1;
        put(chrom_buf + chrom_off[tid[i]], chrom_l);
        out[o++] = '\t';
        put_int(start0[i]);
        out[o++] = '\t';
        put_int(end[i]);
        out[o++] = '\t';
        put(name_buf + name_off[i], name_l);
        out[o++] = '\t';
        put_int(mapq[i]);
        out[o++] = '\t';
        out[o++] = is_rev[i] ? '-' : '+';
        out[o++] = '\t';
        put_int(start0[i]);
        out[o++] = '\t';
        put_int(end[i]);
        const char* z = "\t0\t";
        put((const uint8_t*)z, 3);
        put_int(ne);
        out[o++] = '\t';
        for (int64_t j = exon_off[i]; j < exon_off[i + 1]; ++j) {
            put_int(sizes[j]);
            out[o++] = ',';
        }
        out[o++] = '\t';
        for (int64_t j = exon_off[i]; j < exon_off[i + 1]; ++j) {
            put_int(rel_starts[j]);
            out[o++] = ',';
        }
        out[o++] = '\n';
    }
    return o;
}

// Chain DP + backtrack for SMALL anchor rows (align/chain.py semantics,
// float64).  Spurious secondary clusters carry 2-8 anchors and made up
// ~75% of device rows at 500k scale — each wave of them cost extra
// ~36 ms relay calls; here they chain in ~1 us/row on the host.
// mask_out bit0 = primary member, bit1 = secondary member.
void chain_small_batch_c(
    const int32_t* qpos, const int32_t* gpos, const int32_t* n_anchor,
    int64_t n_rows, int64_t cap,
    int32_t k, int32_t window, int64_t max_intron, int64_t max_qgap,
    double gap_open, double gap_scale, double intron_scale,
    int64_t min_intron_gap, double min_score,
    uint8_t* mask_out, float* ps_out, float* ss_out) {
    std::vector<double> f(cap);
    std::vector<int64_t> parent(cap), pri(cap), sec(cap);
    std::vector<int64_t> bt_order(cap), bt_tmp(cap);   // backtrack scratch,
    std::vector<uint8_t> bt_used(cap);                 // hoisted off the row loop
    for (int64_t row = 0; row < n_rows; ++row) {
        const int32_t* q = qpos + row * cap;
        const int32_t* r = gpos + row * cap;
        int n = n_anchor[row];
        uint8_t* mask = mask_out + row * cap;
        std::memset(mask, 0, (size_t)cap);
        ps_out[row] = 0.0f;
        ss_out[row] = 0.0f;
        if (n <= 0) continue;
        for (int i = 0; i < n; ++i) { f[i] = (double)k; parent[i] = -1; }
        for (int i = 1; i < n; ++i) {
            int j0 = i - window < 0 ? 0 : i - window;
            double best = -1e300;
            int bestj = -1;
            for (int j = j0; j < i; ++j) {
                int64_t dq = (int64_t)q[i] - q[j];
                int64_t dr = (int64_t)r[i] - r[j];
                if (dq <= 0 || dr <= 0 || dq > max_qgap || dr > max_intron)
                    continue;
                double gain = (double)(dq < dr ? dq : dr);
                if (gain > k) gain = k;
                int64_t dd = dr - dq;
                double add = dd < 0 ? (double)(-dd) : (double)dd;
                double lin = gap_open + gap_scale * add;
                double cost;
                if (dd == 0) cost = 0.0;
                else if (dd > min_intron_gap) {
                    double logc = gap_open + intron_scale * std::log2(add + 1.0);
                    cost = logc < lin ? logc : lin;
                } else cost = lin;
                double sc = f[j] + gain - cost;
                if (sc > best) { best = sc; bestj = j; }
            }
            if (bestj >= 0 && best > f[i]) { f[i] = best; parent[i] = bestj; }
        }
        int64_t pn = 0, sn = 0;
        double ps = 0.0, ss = 0.0;
        backtrack_impl(f.data(), parent.data(), n, min_score, 48,
                       pri.data(), &pn, sec.data(), &sn, &ps, &ss,
                       bt_order.data(), bt_used.data(), bt_tmp.data());
        for (int64_t t = 0; t < pn; ++t) mask[pri[t]] |= 1;
        for (int64_t t = 0; t < sn; ++t) mask[sec[t]] |= 2;
        ps_out[row] = (float)ps;
        ss_out[row] = (float)ss;
    }
}

}  // extern "C"

extern "C" {

// check_with_short_sj over the has_known_site reads, IN ORDER, sharing the
// last_sj_i cursor exactly like the reference sweep (transcript/classify.py::
// check_with_short_sj; reference update_gtf.c:589-709 + the c:947 call
// site).  Reads arrive as idx[] rows of the bam SoA; supported_out[t]=1
// when every novel junction of read idx[t] has short-read support.
// unreliable_junction_flag rows and the has_unreliable_junction flag are
// written in place.  Replaces the last per-read python loop of pass 2.
int sj_check_batch_c(
    const int32_t* b_es, const int32_t* b_ee, int64_t b_w,
    const int32_t* b_en, const int32_t* b_tid,
    const int32_t* b_start, const int32_t* b_end,
    const uint8_t* njf, int64_t njf_w,
    uint8_t* urj, int64_t urj_w,
    uint8_t* f_has_urj,
    const int64_t* idx, int64_t m,
    const int32_t* sj_tid, const int32_t* sj_don, const int32_t* sj_acc,
    const int32_t* sj_uniq, const int32_t* sj_multi, int64_t sj_n,
    int ss_dis, int min_sj_cnt, int use_multi,
    uint8_t* supported_out) {
    // check_short_sj1 (update_gtf.c:589-603): scan forward from i_start
    // until a junction matches within ss_dis with enough support, or the
    // table passes the intron end.
    auto sj1 = [&](int32_t tid, int64_t start, int64_t end,
                   int64_t i_start) -> bool {
        for (int64_t i = i_start; i < sj_n; ++i) {
            if (sj_tid[i] > tid || (sj_tid[i] == tid && sj_don[i] >= end))
                return false;
            if (std::llabs((int64_t)sj_don[i] - start) <= ss_dis &&
                std::llabs((int64_t)sj_acc[i] - end) <= ss_dis) {
                int64_t cnt = sj_uniq[i] + (use_multi ? sj_multi[i] : 0);
                if (cnt >= min_sj_cnt) return true;
            }
        }
        return false;
    };
    int64_t cur = 0;  // last_sj_i
    for (int64_t t = 0; t < m; ++t) {
        int64_t bi = idx[t];
        const int32_t* bs = b_es + bi * b_w;
        const int32_t* be = b_ee + bi * b_w;
        int en = b_en[bi];
        const uint8_t* nj = njf + bi * njf_w;
        uint8_t* ur = urj + bi * urj_w;
        bool ret = false;        // reference returns 0 when the loop ends
        int64_t i = cur;
        while (i < sj_n) {
            if (sj_tid[i] < b_tid[bi] ||
                (sj_tid[i] == b_tid[bi] && sj_acc[i] <= b_start[bi])) {
                ++i;
                cur = i;
            } else if (sj_tid[i] > b_tid[bi] ||
                       (sj_tid[i] == b_tid[bi] && sj_don[i] >= b_end[bi])) {
                ret = false;     // window miss: no junction blamed (c:615)
                break;
            } else {
                ret = true;
                for (int j = 0; j < en - 1; ++j) {
                    // sj_map[j] = 1 - novel_junction_flag[j] (c:700-703)
                    if (nj[j] && !sj1(b_tid[bi], (int64_t)be[j] + 1,
                                      (int64_t)bs[j + 1] - 1, i)) {
                        ur[j] = 1;
                        ret = false;
                    }
                }
                break;
            }
        }
        f_has_urj[bi] = ret ? 0 : 1;
        supported_out[t] = ret ? 1 : 0;
    }
    return 0;
}

// split_trans fragment ranges (reference update_gtf.c:837-913): for each
// read, cut at unreliable junctions; a fragment [lo, hi] (exon indices,
// inclusive) survives when it is multi-exon AND saw >=1 novel and >=1
// known junction — counting the cutting junction's own novelty, exactly
// like the reference (c:845-846 run before the c:847 cut test).  Writes
// up to frag_stride (lo, hi) pairs per read; n_frag_out[t] = count.
// Row assembly (flag copies + ".split.N" ids) stays host-side per
// FRAGMENT, not per read.
int split_trans_batch_c(
    const int32_t* b_en,
    const uint8_t* njf, int64_t njf_w,
    const uint8_t* urj, int64_t urj_w,
    const int64_t* idx, int64_t m,
    int32_t* frag_lo, int32_t* frag_hi, int64_t frag_stride,
    int32_t* n_frag_out) {
    for (int64_t t = 0; t < m; ++t) {
        int64_t bi = idx[t];
        int en = b_en[bi];
        const uint8_t* nj = njf + bi * njf_w;
        const uint8_t* ur = urj + bi * urj_w;
        int32_t* lo_out = frag_lo + t * frag_stride;
        int32_t* hi_out = frag_hi + t * frag_stride;
        int nf = 0;
        int last = 0;
        bool has_novel = false, has_known = false;
        for (int i = 0; i < en - 1; ++i) {
            if (nj[i]) has_novel = true; else has_known = true;
            if (ur[i]) {
                if (has_novel && has_known && i - last >= 1 &&
                    nf < frag_stride) {
                    lo_out[nf] = last;
                    hi_out[nf] = i;
                    ++nf;
                }
                last = i + 1;
                has_novel = has_known = false;
            }
        }
        if (has_novel && has_known && (en - 1) - last >= 1 &&
            nf < frag_stride) {
            lo_out[nf] = last;
            hi_out[nf] = en - 1;
            ++nf;
        }
        n_frag_out[t] = nf;
    }
    return 0;
}

}  // extern "C"
