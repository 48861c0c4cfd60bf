"""Splice-point refinement between chain anchors.

Given a candidate intron between two anchor blocks, choose the query split
point j (and thus the donor/acceptor positions) maximizing
    matches(left prefix) + matches(right suffix) + motif_bonus
— prefix sums make the scan O(gap length) and fully vectorized.  Canonical
motifs considered: GT..AG ('+'), CT..AC ('-'), with smaller bonuses for
GC..AG / AT..AC (and their complements), mirroring the minimap2 splice
model's preference order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# donor/acceptor dinucleotide codes (A0 C1 G2 T3)
_GT = (2, 3)
_AG = (0, 2)
_CT = (1, 3)
_AC = (0, 1)
_GC = (2, 1)
_AT = (0, 3)

BONUS_CANON = 10.0   # GT..AG / CT..AC
BONUS_SEMI = 8.0     # GC..AG / AT..AC and complements: a gap of 2 below
                     # canonical keeps GT..AG preferred on equal flank
                     # evidence, but lets ONE clean flank match (+1/-2 per
                     # base) outweigh it — minor-spliceosome introns no
                     # longer lose to GT..AG look-alikes a few bp away
                     # (the dominant ONT-profile failure mode)

# Anchor-position prior weight.  The caller passes (el_exp, er_exp) — the
# edge pullback it applied to each flank, i.e. how many bases of the gap
# are EXACT-MATCH anchored sequence deliberately re-exposed to the DP.
# Anchors pin those bases to the exon, so the junction can never sit
# inside them: placements with donor offset < el_exp or acceptor offset
# < er_exp (under-slides into the anchored flank — the classic wobble
# ambiguity, which the lexicographic argmax used to resolve TOWARD the
# under-slide) pay a one-sided hinge penalty of W_POS per base:
#     W_POS * (max(el_exp - don_off, 0) + max(er_exp - acc_off, 0)).
# Placements beyond the anchors (error slack before the junction) stay
# free, so truth is never penalized.  Dyadic (3/8) so the f32 device
# combine (ops/junction.py, csrc/combine.cu) agrees bit-for-bit with this
# f64 math.
W_POS = 0.375


def _dinuc_eq(arr: np.ndarray, pos: np.ndarray, pair: Tuple[int, int]) -> np.ndarray:
    """arr[pos]==pair[0] and arr[pos+1]==pair[1] with bounds safety."""
    n = len(arr)
    ok = (pos >= 0) & (pos + 1 < n)
    a = np.where(ok, arr[np.clip(pos, 0, n - 1)], -1)
    b = np.where(ok, arr[np.clip(pos + 1, 0, n - 1)], -1)
    return (a == pair[0]) & (b == pair[1])


def refine_splice(q: np.ndarray, ref: np.ndarray, left_ref: int, right_ref: int,
                  el_exp: int = 0, er_exp: int = 0) -> Tuple[int, float, int]:
    """Dispatch wrapper; native kernel when available (bit-equal)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        score = ctypes.c_double()
        vote = ctypes.c_int32()
        j = lib.refine_splice_c(
            np.ascontiguousarray(q, np.uint8), len(q), ref, len(ref),
            int(left_ref), int(right_ref), int(el_exp), int(er_exp),
            ctypes.byref(score), ctypes.byref(vote))
        return j, float(score.value), int(vote.value)
    return refine_splice_np(q, ref, left_ref, right_ref, el_exp, er_exp)


def refine_splice_np(q: np.ndarray, ref: np.ndarray, left_ref: int,
                     right_ref: int, el_exp: int = 0, er_exp: int = 0
                     ) -> Tuple[int, float, int]:
    """Place the intron inside a gap region.

    q          : query gap codes (length m, may be 0)
    ref        : full reference chrom codes
    left_ref   : ref offset where the left flank resumes (0-based, first
                 unaligned ref base after the left anchor block)
    right_ref  : ref offset one past the last unaligned ref base before the
                 right anchor block (exclusive)

    The intron occupies ref [left_ref + j, right_ref - (m - j)) for the
    chosen split j.  Returns (j, score, strand_vote) where strand_vote is
    +1 for '+'-motifs, -1 for '-'-motifs, 0 for non-canonical.
    """
    m = len(q)
    j = np.arange(m + 1)
    # matches of left prefix q[:j] vs ref[left_ref : left_ref+j]
    if m > 0:
        lmatch = (q == ref[left_ref: left_ref + m]).astype(np.float64)
        lpre = np.concatenate([[0.0], np.cumsum(lmatch)])
        rmatch = (q == ref[right_ref - m: right_ref]).astype(np.float64)
        rsuf = np.concatenate([[0.0], np.cumsum(rmatch[::-1])])[::-1]
    else:
        lpre = np.zeros(1)
        rsuf = np.zeros(1)
    don = left_ref + j            # first intron base
    acc = right_ref - (m - j) - 2  # position of acceptor dinuc start (last-1)
    plus = (_dinuc_eq(ref, don, _GT) & _dinuc_eq(ref, acc, _AG)).astype(np.float64) * BONUS_CANON
    minus = (_dinuc_eq(ref, don, _CT) & _dinuc_eq(ref, acc, _AC)).astype(np.float64) * BONUS_CANON
    semi_p = (_dinuc_eq(ref, don, _GC) & _dinuc_eq(ref, acc, _AG)).astype(np.float64) * BONUS_SEMI
    semi_p2 = (_dinuc_eq(ref, don, _AT) & _dinuc_eq(ref, acc, _AC)).astype(np.float64) * BONUS_SEMI
    semi_m = (_dinuc_eq(ref, don, _CT) & _dinuc_eq(ref, acc, _GC)).astype(np.float64) * BONUS_SEMI
    semi_m2 = (_dinuc_eq(ref, don, _GT) & _dinuc_eq(ref, acc, _AT)).astype(np.float64) * BONUS_SEMI
    bonus_p = np.maximum(plus, np.maximum(semi_p, semi_p2))
    bonus_m = np.maximum(minus, np.maximum(semi_m, semi_m2))
    bonus = np.maximum(bonus_p, bonus_m)
    # anchor-position prior (one-sided hinge; see W_POS)
    pen = W_POS * (np.maximum(el_exp - j, 0) +
                   np.maximum(er_exp - (m - j), 0))
    score = lpre + rsuf + bonus - pen
    # ties resolve to the LARGEST j (see refine_splice_indel_np)
    best = m - int(np.argmax(score[::-1]))
    if bonus_p[best] > bonus_m[best]:
        vote = 1
    elif bonus_m[best] > bonus_p[best]:
        vote = -1
    else:
        vote = 0
    return best, float(score[best]), vote


# ---------------------------------------------------------------------------
# Indel-aware junction placement (two-sided banded DP + motif-scored join).
#
# A long-read junction region may carry small indels right at the splice
# boundary (the toy CCS read does), which a pure query-split cannot place on
# the annotated donor/acceptor.  Here both flanks are aligned with a banded
# shift DP and joined over all (query split, left shift, right shift)
# combinations with the motif bonus — the host reference of the Pallas
# splice-DP kernel.
# ---------------------------------------------------------------------------

MATCH = 1.0
MISMATCH = -2.0
GAP = -3.0
NEG = -1e18


def _shift_dp(q: np.ndarray, ref_win: np.ndarray, B: int):
    """Banded prefix DP.

    S[j, c] = best score aligning q[:j] to ref_win[: j + (c - B)] with
    ref-consumption shift s = c - B in [-B, B].  Returns the [m+1, 2B+1]
    score matrix (NEG where invalid).
    """
    m = len(q)
    W = 2 * B + 1
    nr = len(ref_win)
    S = np.full((m + 1, W), NEG)
    S[0, B] = 0.0
    for s in range(1, B + 1):
        if s <= nr:
            S[0, B + s] = GAP * s
    cc = np.arange(W)
    refpad = np.concatenate([ref_win.astype(np.int16), [-1]])
    for j in range(1, m + 1):
        prev = S[j - 1]
        rlen = j + cc - B                        # ref consumed per column
        valid = (rlen >= 0) & (rlen <= nr)
        # diagonal: consume q[j-1] and ref_win[rlen-1]
        ridx = np.clip(rlen - 1, 0, nr)
        diag_ok = valid & (rlen >= 1)
        sub = np.where(refpad[ridx] == q[j - 1], MATCH, MISMATCH)
        diag = np.where(diag_ok, prev + sub, NEG)
        # insertion (query-only): from prev[c+1]
        ins = np.full(W, NEG)
        ins[:-1] = prev[1:] + GAP
        ins = np.where(valid, ins, NEG)
        row = np.maximum(diag, ins)
        # deletion (ref-only): running scan, shift increases (W is small)
        best = NEG
        for c in range(W):
            best = max(best + GAP, row[c])
            if valid[c]:
                row[c] = best
            else:
                row[c] = NEG
                best = NEG
        S[j] = row
    return S


def _traceback_ops(q: np.ndarray, ref_win: np.ndarray, S: np.ndarray,
                   j: int, c: int, B: int):
    """Recover (op, len) runs for the DP cell (j, c); ops use BAM codes
    M=0 I=1 D=2."""
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    while j > 0 or c != B:
        s = c - B
        rlen = j + s
        cur = S[j, c]
        if j > 0 and rlen >= 1:
            d = MATCH if q[j - 1] == ref_win[rlen - 1] else MISMATCH
            if abs(S[j - 1, c] + d - cur) < 1e-9:
                push(0)
                j -= 1
                continue
        if c > 0 and abs(S[j, c - 1] + GAP - cur) < 1e-9:
            push(2)
            c -= 1
            continue
        if j > 0 and c + 1 < 2 * B + 1 and abs(S[j - 1, c + 1] + GAP - cur) < 1e-9:
            push(1)
            j -= 1
            c += 1
            continue
        # numerical fallback
        if j > 0:
            push(0)
            j -= 1
        else:
            push(2)
            c -= 1
    return [(op, l) for op, l in reversed(ops)]


def _motif_bonus(ref: np.ndarray, don: int, last: int):
    """(bonus, vote) for intron [don, last] (0-based inclusive)."""
    n = len(ref)
    if don < 0 or last + 1 > n or last - don + 1 < 2:
        return 0.0, 0
    d = (int(ref[don]), int(ref[don + 1]))
    a = (int(ref[last - 1]), int(ref[last]))
    if d == _GT and a == _AG:
        return BONUS_CANON, 1
    if d == _CT and a == _AC:
        return BONUS_CANON, -1
    if (d == _GC and a == _AG) or (d == _AT and a == _AC):
        return BONUS_SEMI, 1
    if (d == _CT and a == _GC) or (d == _GT and a == _AT):
        return BONUS_SEMI, -1
    return 0.0, 0


def refine_splice_indel(q: np.ndarray, ref: np.ndarray, left_ref: int,
                        right_ref: int, B: int = 4, min_intron: int = 20,
                        el_exp: int = 0, er_exp: int = 0):
    """Dispatch to the native kernel when available (bit-equal; see
    tests/test_native.py), else the numpy reference below."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return refine_splice_indel_np(q, ref, left_ref, right_ref, B,
                                      min_intron, el_exp, er_exp)
    import ctypes
    m = len(q)
    cap = m + 2 * B + 4
    left_ops = np.zeros(2 * cap, np.int32)
    right_ops = np.zeros(2 * cap, np.int32)
    ln = ctypes.c_int32()
    rn = ctypes.c_int32()
    ilen = ctypes.c_int64()
    vote = ctypes.c_int32()
    score = ctypes.c_double()
    q8 = np.ascontiguousarray(q, np.uint8)
    rc = lib.refine_splice_indel_c(
        q8, m, ref, len(ref), left_ref, right_ref, B, min_intron,
        int(el_exp), int(er_exp),
        left_ops, ctypes.byref(ln), right_ops, ctypes.byref(rn),
        ctypes.byref(ilen), ctypes.byref(vote), ctypes.byref(score))
    if rc != 0:
        return None
    lo = [(int(left_ops[2 * i]), int(left_ops[2 * i + 1]))
          for i in range(ln.value)]
    ro = [(int(right_ops[2 * i]), int(right_ops[2 * i + 1]))
          for i in range(rn.value)]
    return lo, int(ilen.value), ro, int(vote.value), float(score.value)


def refine_splice_indel_np(q: np.ndarray, ref: np.ndarray, left_ref: int,
                           right_ref: int, B: int = 4, min_intron: int = 20,
                           el_exp: int = 0, er_exp: int = 0):
    """Indel-aware intron placement in the gap between two anchor blocks.

    q         : query gap codes (m bases)
    ref       : full concatenated reference codes
    left_ref  : 0-based ref offset where the left flank resumes
    right_ref : 0-based ref offset of the right anchor block start

    Returns (left_ops, intron_len, right_ops, vote, score) where the ops are
    (op, len) runs in BAM codes covering the query gap; or None when no
    intron >= min_intron fits.
    """
    m = len(q)
    span = right_ref - left_ref
    max_left = min(m + B, span)
    lwin = ref[left_ref: left_ref + max_left]
    max_right = min(m + B, span)
    rwin = ref[right_ref - max_right: right_ref][::-1]

    SL = _shift_dp(q, lwin, B)
    SR = _shift_dp(q[::-1], rwin, B)

    W = 2 * B + 1
    n = len(ref)
    # donor candidates: don = left_ref + (j + cl - B), j+cl in [0, m+2B]
    lref_all = np.arange(m + 2 * B + 1)
    don_all = left_ref + lref_all - B
    d0 = ref[np.clip(don_all, 0, n - 1)]
    d1 = ref[np.clip(don_all + 1, 0, n - 1)]
    don_valid = (don_all >= 0) & (don_all + 1 < n)
    # donor class: 0 none, 1 GT, 2 CT, 3 GC, 4 AT
    dclass = np.zeros(len(don_all), np.int8)
    dclass[(d0 == 2) & (d1 == 3)] = 1
    dclass[(d0 == 1) & (d1 == 3)] = 2
    dclass[(d0 == 2) & (d1 == 1)] = 3
    dclass[(d0 == 0) & (d1 == 3)] = 4
    dclass[~don_valid] = 0
    # acceptor candidates: last = right_ref - ((m-j) + cr - B) - 1
    rref_all = np.arange(m + 2 * B + 1)
    last_all = right_ref - (rref_all - B) - 1
    a0 = ref[np.clip(last_all - 1, 0, n - 1)]
    a1 = ref[np.clip(last_all, 0, n - 1)]
    acc_valid = (last_all - 1 >= 0) & (last_all < n)
    # acceptor class: 0 none, 1 AG, 2 AC, 3 GC, 4 AT
    aclass = np.zeros(len(last_all), np.int8)
    aclass[(a0 == 0) & (a1 == 2)] = 1
    aclass[(a0 == 0) & (a1 == 1)] = 2
    aclass[(a0 == 2) & (a1 == 1)] = 3
    aclass[(a0 == 0) & (a1 == 3)] = 4
    aclass[~acc_valid] = 0
    # (donor class, acceptor class) -> (bonus, vote)
    bonus_tab = np.zeros((5, 5))
    vote_tab = np.zeros((5, 5), np.int8)
    bonus_tab[1, 1] = BONUS_CANON; vote_tab[1, 1] = 1    # GT..AG
    bonus_tab[2, 2] = BONUS_CANON; vote_tab[2, 2] = -1   # CT..AC
    bonus_tab[3, 1] = BONUS_SEMI; vote_tab[3, 1] = 1     # GC..AG
    bonus_tab[4, 2] = BONUS_SEMI; vote_tab[4, 2] = 1     # AT..AC
    bonus_tab[2, 3] = BONUS_SEMI; vote_tab[2, 3] = -1    # CT..GC
    bonus_tab[1, 4] = BONUS_SEMI; vote_tab[1, 4] = -1    # GT..AT

    jj = np.arange(m + 1)
    cl = np.arange(W)
    cr = np.arange(W)
    d_idx = jj[:, None] + cl[None, :]                    # [m+1, W] into dclass
    a_idx = (m - jj)[:, None] + cr[None, :]              # [m+1, W] into aclass
    dc = dclass[d_idx]                                   # [m+1, W]
    ac = aclass[a_idx]                                   # [m+1, W]
    don_mat = don_all[d_idx]                             # [m+1, W]
    last_mat = last_all[a_idx]                           # [m+1, W]
    bonus = bonus_tab[dc[:, :, None], ac[:, None, :]]    # [m+1, W, W]
    ilen = last_mat[:, None, :] - don_mat[:, :, None] + 1
    SRr = SR[::-1]                                       # SRr[j] = SR[m-j]
    # anchor-position prior on the donor/acceptor offsets (d_idx - B is the
    # ref consumed by the left flank, a_idx - B by the right; one-sided
    # hinge — see W_POS)
    pen_l = W_POS * np.maximum(el_exp - (d_idx - B), 0)  # [m+1, W]
    pen_r = W_POS * np.maximum(er_exp - (a_idx - B), 0)  # [m+1, W]
    total = (SL[:, :, None] + SRr[:, None, :] + bonus
             - pen_l[:, :, None] - pen_r[:, None, :])
    total = np.where(ilen >= min_intron, total, NEG)
    total = np.where(don_valid[d_idx][:, :, None] &
                     acc_valid[a_idx][:, None, :], total, NEG)
    # ties resolve to the LARGEST (j, cl, cr): wobble tie intervals carry
    # the true junction at their large end far more often than the small
    # end (the small end merely reuses pulled-back anchored matches)
    flat = int(np.argmax(total[::-1, ::-1, ::-1]))
    sc = float(total[::-1, ::-1, ::-1].flat[flat])
    if sc <= NEG / 2:
        return None
    j, cl_i, cr_i = np.unravel_index(flat, total.shape)
    j = m - int(j)
    cl = W - 1 - int(cl_i)
    cr = W - 1 - int(cr_i)
    don = int(don_all[j + cl])
    last = int(last_all[(m - j) + cr])
    vote = int(vote_tab[dclass[j + cl], aclass[(m - j) + cr]])
    left_ops = _traceback_ops(q, lwin, SL, j, cl, B)
    right_rev = _traceback_ops(q[::-1], rwin, SR, m - j, cr, B)
    right_ops = [(op, l) for op, l in reversed(right_rev)]
    return left_ops, last - don + 1, right_ops, vote, sc
