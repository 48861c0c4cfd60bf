"""Cross-read splice-junction consensus polishing, with its placement DP
on the card.

Counterpart of lr2rmats_tpu/align/polish.py, whose host code is copied
here unchanged: the support collection, consensus winners, tie resolution,
windows, the scalar forced placement (`_constrained_place`, align/splice.py
`_shift_dp` + traceback) and the CIGAR rewrite.

Single-read junction placement is ambiguous when sequencing errors corrupt
the bases flanking a splice site: a look-alike motif a few bases away can
outscore the true junction for THAT read, while sibling reads of the same
gene place it correctly.  This pass aggregates junction support across all
reads of a run and re-places near-miss junctions onto the locally dominant
placement (the STAR 2-pass `--sjdbGTFfile` / minimap2 `--junc-bed` role,
annotation-free).  A junction moves only to a strictly better-supported
placement within SNAP bp on both ends, and only when the read's own bases
support it within DELTA score of the old one.  CIGAR, NM and AS are
rewritten exactly.

The batched forced-placement DP is the port's:

  * `place_lanes` — both flank shift DPs (ops/splice.shift_dp) and the
    split and both tracebacks (ops/splice.polish_trace) on the same
    device, two kernels back to back: `_finish_place`'s result per lane;
  * `constrained_place_many` — packs the tasks as the reference's
    `_constrained_place_many` does (int8 lanes, `_PLACE_M` rows, lanes
    padded to `_PLACE_G`), copies the traced lanes back once and returns
    `_constrained_place`'s full result per batched task, where the
    reference returns ("defer", score) and re-runs the host DP for the
    traceback of each placement it accepts; with `device=None` every task
    runs the host DP (the reference's `host_dp=True`, the host aligner
    backend's polish);
  * `polish_batch` — the reference's body with the port's placement, and
    without the host re-run.

Spans (utils/log.py) split `polish_batch` into five parts: support (the
junction table, support, consensus winners, holders index), ties
(`_resolve_weight_ties`), windows (the per-record windows and
`constrained_place_many`'s triage and task packing), place (the copies,
`place_lanes` and the copy back; the host DP with device=None) and accept
(the sequential accept loop).  Counters count junction rows, winners,
placements tried, device tasks, host placement DPs of tried junctions
(`host_dp`: multi-junction records, windows the batch cannot carry, the
device=None path; never a device task) and junctions re-placed.

Dropped with respect to the reference: the relay canary (a small first
call whose slowness routed the rest to the host), the `device_stats`
failure fallback and the debug prints.  A kernel failure raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.fasta import _COMP
from ..io.sam import (FSECONDARY, FUNMAP, OP_D, OP_I, OP_M, OP_N, OP_S,
                      AlnRec, _CONSUME)
from ..ops.splice import TRACE_HEAD, polish_trace, shift_dp, trace_runs
from ..utils.log import count, span
from .records import RecordBatch
from .splice import (GAP, MATCH, MISMATCH, NEG, _motif_bonus, _shift_dp,
                     _traceback_ops)

SNAP = 40        # max per-end distance between a junction and its winner
DELTA = 6.0      # max score the read may lose by accepting the winner
DELTA_STRONG = 30.0  # ... when the winner dominates (>= 2x weight + 2):
                 # error pileups can make a misplacement outscore truth by
                 # a lot for ONE read; dominant clean siblings override it
FLANK_Q = 24     # query bases re-aligned on each side of the junction
B = 8            # flank DP band (wider than the aligner's junction DP:
                 # the old alignment's flank may already carry several
                 # indels that the re-placement has to absorb)
FLK = 8          # flank bases checked for the clean-vote weight
W_CLEAN = 2      # vote weight of a junction with both flanks error-free


def _cigar_ops(cigar: np.ndarray) -> List[Tuple[int, int]]:
    return [(int(c) & 0xF, int(c) >> 4) for c in cigar]


# ------------------------------------------------------------------ parse
def _junction_table(rb: RecordBatch) -> dict:
    """One vectorized CIGAR parse of the whole batch.

    Returns per-entry arrays (ops, lens, q_before) and per-junction arrays
    (j = entry index, rj = record, opi = op index within the record,
    don/acc = 0-based chrom-local first/last intron base)."""
    counts = np.diff(rb.cig_offs)
    ops = (rb.cig_buf & 0xF).astype(np.int64)
    lens = (rb.cig_buf >> 4).astype(np.int64)
    rid = np.repeat(np.arange(rb.n, dtype=np.int64), counts)
    if len(ops):
        consume = np.asarray(_CONSUME, np.int64)[ops]
        q_excl = np.concatenate([[0], np.cumsum(lens * (consume & 1))[:-1]])
        r_excl = np.concatenate(
            [[0], np.cumsum(lens * ((consume & 2) >> 1))[:-1]])
        start = np.minimum(rb.cig_offs[:-1], len(ops) - 1)
        q_before = q_excl - q_excl[start][rid]
        r_before = r_excl - r_excl[start][rid]
    else:
        q_before = r_before = np.zeros(0, np.int64)
    j = np.nonzero(ops == OP_N)[0]
    rj = rid[j]
    opi = j - rb.cig_offs[:-1][rj]
    don = rb.pos[rj] + r_before[j]
    acc = don + lens[j] - 1
    return dict(ops=ops, lens=lens, counts=counts, q_before=q_before,
                j=j, rj=rj, opi=opi, don=don, acc=acc)


def _support_batch(rb: RecordBatch, jt: dict, genome_codes: np.ndarray,
                   chrom_offsets: np.ndarray
                   ) -> Dict[Tuple[int, int, int], int]:
    """Weighted junction support over primary mapped records.

    A junction flanked on both sides by >= FLK exactly-matching M bases
    votes with weight W_CLEAN: an error-free flank pins the placement,
    while the error-corrupted flanks that cause misplacements get weight
    1 — so a clean sibling outvotes one error-driven misplacement even at
    1:1 read counts."""
    j, rj = jt["j"], jt["rj"]
    if not len(j):
        return {}
    ops, lens, q_before = jt["ops"], jt["lens"], jt["q_before"]
    voter = (rb.flag[rj] & (FSECONDARY | FUNMAP)) == 0
    inner = (jt["opi"] > 0) & (jt["opi"] < jt["counts"][rj] - 1)
    jl = np.where(inner, j - 1, j)
    jr = np.where(inner, j + 1, j)
    flank = (inner & (ops[jl] == OP_M) & (lens[jl] >= FLK) &
             (ops[jr] == OP_M) & (lens[jr] >= FLK))
    w = np.ones(len(j), np.int64)
    cand = np.nonzero(voter & flank)[0]
    if len(cand):
        lq = q_before[j[cand]]          # query offset at donor side
        rq = q_before[jr[cand]]         # query offset at acceptor side
        don, acc = jt["don"][cand], jt["acc"][cand]
        off = chrom_offsets[rb.tid[rj[cand]]]
        gl = off + don - FLK
        gr = off + acc + 1
        G = len(genome_codes)
        inb = (gl >= 0) & (gr + FLK <= G)
        sid = rb.seq_id[rj[cand]]
        sbase = rb.seq_offs[sid]
        L = rb.seq_offs[sid + 1] - sbase
        rc = rb.seq_rc[rj[cand]].astype(bool)[:, None]
        ar = np.arange(FLK, dtype=np.int64)[None, :]

        def asq(idx):
            """as-aligned query codes at positions idx (reverse-
            complemented reads gather from the forward buffer mirrored)."""
            fwd = np.where(rc, L[:, None] - 1 - idx, idx) + sbase[:, None]
            v = rb.seq_buf[fwd]
            return np.where(rc, _COMP[v], v)

        gil = np.clip(gl, 0, max(G - FLK, 0))[:, None] + ar
        gir = np.clip(gr, 0, max(G - FLK, 0))[:, None] + ar
        clean = (inb &
                 (asq(lq[:, None] - FLK + ar) == genome_codes[gil]).all(1) &
                 (asq(rq[:, None] + ar) == genome_codes[gir]).all(1))
        w[cand[clean]] = W_CLEAN
    keys = np.stack([rb.tid[rj].astype(np.int64), jt["don"], jt["acc"]], 1)
    uniq, inv = np.unique(keys[voter], axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, w[voter])
    return {(int(t), int(d), int(a)): int(s)
            for (t, d, a), s in zip(uniq, sums)}


def collect_junction_support(records, genome_codes: np.ndarray,
                             chrom_offsets: np.ndarray
                             ) -> Dict[Tuple[int, int, int], int]:
    """AlnRec-list bridge over `_support_batch`."""
    rb = RecordBatch.from_alnrecs(list(records))
    return _support_batch(rb, _junction_table(rb), genome_codes,
                          chrom_offsets)


def consensus_winners(support: Dict[Tuple[int, int, int], int]
                      ) -> Dict[Tuple[int, int, int], Tuple[int, int, int]]:
    """For each junction, the strictly better-supported junction within
    SNAP bp on both ends (the local-max neighbor), if any."""
    by_tid: Dict[int, List[Tuple[int, int, int]]] = {}
    for (tid, don, acc), c in support.items():
        by_tid.setdefault(tid, []).append((don, acc, c))
    winners: Dict[Tuple[int, int, int], Tuple[int, int, int]] = {}
    for tid, rows in by_tid.items():
        rows.sort()
        dons = np.array([r[0] for r in rows], np.int64)
        for don, acc, c in rows:
            lo = int(np.searchsorted(dons, don - SNAP))
            hi = int(np.searchsorted(dons, don + SNAP, side="right"))
            best_c, best_d, best_a = c, don, acc
            for t in range(lo, hi):
                d2, a2, c2 = rows[t]
                if abs(a2 - acc) <= SNAP and c2 > best_c:
                    best_c, best_d, best_a = c2, d2, a2
            if (best_d, best_a) != (don, acc):
                winners[(tid, don, acc)] = (tid, best_d, best_a)
    return winners


def _window(ops, op_i: int, pos: int, need_l: int = FLANK_Q,
            need_r: int = FLANK_Q):
    """Flank windows around the N run at op_i.

    Returns (ops2, op_i2, q0, r0, left_ops_i, right_ops_j, q_end, r_end)
    where ops2 is `ops` with the outermost included M runs split so the
    window holds only ~need bases (a 600 bp exon M op would otherwise make
    the flank DP 10-20x more expensive for no gain — splitting an M op is
    a semantic no-op and the caller's seam re-merge restores it), op_i2 is
    the N run's index within ops2, [left_ops_i, op_i2) and (op_i2,
    right_ops_j] bound the replaced segment, q0/q_end are query offsets
    and r0/r_end chrom-local ref offsets of the window boundaries.
    Windows never cross another N run.  need_l/need_r are the minimum
    query bases wanted per side (grown by the caller when the junction
    shift must be absorbed by one flank).
    """
    ops = list(ops)
    # clip: split the outermost M op of each flank at the need boundary
    got_q = 0
    for t in range(op_i - 1, -1, -1):
        op, l = ops[t]
        if op in (OP_N, OP_S):
            break
        if op in (OP_M, OP_I):
            if op == OP_M and got_q + l > need_l and got_q < need_l:
                keep = need_l - got_q
                ops[t: t + 1] = [(OP_M, l - keep), (OP_M, keep)]
                op_i += 1
                got_q += l
                break
            got_q += l
            if got_q >= need_l:
                break
    got_q = 0
    for t in range(op_i + 1, len(ops)):
        op, l = ops[t]
        if op in (OP_N, OP_S):
            break
        if op in (OP_M, OP_I):
            if op == OP_M and got_q + l > need_r and got_q < need_r:
                keep = need_r - got_q
                ops[t: t + 1] = [(OP_M, keep), (OP_M, l - keep)]
                break
            got_q += l
            if got_q >= need_r:
                break
    q = 0
    r = pos
    qs, rs = [], []          # query/ref offsets at the START of each op
    for op, l in ops:
        qs.append(q)
        rs.append(r)
        if op in (OP_M, OP_I, OP_S):
            q += l
        if op in (OP_M, OP_D, OP_N):
            r += l
    qs.append(q)
    rs.append(r)
    i = op_i
    got_q = 0
    while i > 0 and got_q < need_l:
        op, l = ops[i - 1]
        if op in (OP_N, OP_S):
            break
        i -= 1
        if op in (OP_M, OP_I):
            got_q += l
    j = op_i
    got_q = 0
    while j + 1 < len(ops) and got_q < need_r:
        op, l = ops[j + 1]
        if op in (OP_N, OP_S):
            break
        j += 1
        if op in (OP_M, OP_I):
            got_q += l
    return ops, op_i, qs[i], rs[i], i, j, qs[j + 1], rs[j + 1]


def _window_score(ops, lo: int, hi: int, q: np.ndarray, q0: int,
                  ref: np.ndarray, r0: int) -> Tuple[float, int, int]:
    """(unit-model score, n_match, NM) of ops[lo:hi+1] (N skipped) with
    query starting at q0 and ref at r0 (global)."""
    sc = 0.0
    nm = 0
    match = 0
    qi, ri = q0, r0
    for op, l in ops[lo: hi + 1]:
        if op == OP_M:
            mism = int(np.sum(q[qi: qi + l] != ref[ri: ri + l]))
            sc += MATCH * (l - mism) + MISMATCH * mism
            nm += mism
            match += l - mism
            qi += l
            ri += l
        elif op == OP_I:
            sc += GAP * l
            nm += l
            qi += l
        elif op == OP_D:
            sc += GAP * l
            nm += l
            ri += l
        elif op == OP_N:
            ri += l
    return sc, match, nm


def _finish_place(qwin, ref, L0, acc, SL, SR, lwin, rwin, m, DL, DR):
    """Shared tail of the forced placement: pick the best split j over the
    two shift-DP matrices (host loop semantics: last maximal j wins),
    trace back both flanks, count match/NM."""
    W = 2 * B + 1
    best = NEG
    bj = bcl = bcr = -1
    for j in range(m + 1):
        cl = DL + B - j
        cr = DR + B - (m - j)
        if not (0 <= cl < W and 0 <= cr < W):
            continue
        sc = SL[j, cl] + SR[m - j, cr]
        if sc >= best and sc > NEG / 2:
            best = sc
            bj, bcl, bcr = j, cl, cr
    if bj < 0:
        return None
    lops = _traceback_ops(qwin, lwin, SL, bj, bcl, B)
    rrev = _traceback_ops(qwin[::-1], rwin, SR, m - bj, bcr, B)
    rops = [(op, l) for op, l in reversed(rrev)]
    nm = 0
    match = 0
    qi = 0
    for side_ops, r_start in ((lops, L0), (rops, acc + 1)):
        ri = r_start
        for op, l in side_ops:
            if op == OP_M:
                mism = int(np.sum(qwin[qi: qi + l] != ref[ri: ri + l]))
                nm += mism
                match += l - mism
                qi += l
                ri += l
            elif op == OP_I:
                nm += l
                qi += l
            else:
                nm += l
                ri += l
    return best, lops, rops, match, nm


def _constrained_place(qwin: np.ndarray, ref: np.ndarray, L0: int, R0: int,
                       don: int, acc: int):
    """Best split of qwin with the intron FORCED to [don, acc] (global
    coords); flanks run L0->don and acc+1->R0.  Returns
    (score, left_ops, right_ops, match, nm) or None if infeasible in
    band B."""
    m = len(qwin)
    DL = don - L0                    # ref consumed by the left flank
    DR = R0 - 1 - acc                # ref consumed by the right flank
    if DL < 0 or DR < 0 or DL > m + B or DR > m + B:
        return None
    span = R0 - L0
    side = min(m + B, span)
    lwin = ref[L0: L0 + side]
    rwin = ref[R0 - side: R0][::-1]
    SL = _shift_dp(qwin, lwin, B)
    SR = _shift_dp(qwin[::-1], rwin, B)
    return _finish_place(qwin, ref, L0, acc, SL, SR, lwin, rwin, m, DL, DR)


# batched forced placement: tasks padded to [_PLACE_M, G] lanes, G a
# multiple of _PLACE_G, so the device sees a handful of shapes per run
_PLACE_M = 192            # max query-window length eligible for the batch
_PLACE_G = 256            # lane padding quantum


def place_lanes(q, qr, lwin, rwin, m, dl, dr, band: int = B
                ) -> torch.Tensor:
    """The forced placement of every lane on q's device: both flank shift
    DPs, then the best split (last maximal j, NEG where no split fits the
    band) and both tracebacks, [G, trace_width(M, band)] int32 rows
    (ops/splice.py polish_trace)."""
    SL = shift_dp(q, lwin, m, band)                  # [M+1, W, G]
    SR = shift_dp(qr, rwin, m, band)
    return polish_trace(SL, SR, q, qr, lwin, rwin, m, dl, dr, band)


def _traced(row: np.ndarray, R: int):
    """`_constrained_place`'s (score, lops, rops, match, nm) from one lane's
    row of place_lanes (R runs a flank); None where no split fits."""
    bj, match, nm, nl, nr = (int(v) for v in row[1:TRACE_HEAD])
    if bj < 0:
        return None
    if nl < 0 or nr < 0:
        # a walk over finite cells always finds one: a fault of the kernel
        raise RuntimeError(f"polish_trace: a walk from split {bj} found no "
                           f"predecessor (run counts {nl}, {nr})")
    runs = row[TRACE_HEAD:].astype(np.int64)
    lops = [(int(w) & 0xF, int(w) >> 4) for w in runs[:nl]]
    rops = [(int(w) & 0xF, int(w) >> 4) for w in runs[R: R + nr]]
    return float(row[:1].view(np.float32)[0]), lops, rops, match, nm


def constrained_place_many(items: List[tuple], ref: np.ndarray,
                           device=None) -> List[Optional[tuple]]:
    """`_constrained_place` over (qwin, L0, R0, don, acc) tasks.

    Infeasible tasks give None.  Tasks the batch cannot carry (window
    longer than _PLACE_M, span < m+B) run the host DP.  The rest run
    `place_lanes` on `device` and come back, in one copy, with their
    tracebacks: the same full result.  With device=None they run the host
    DP too.  Counts the host DPs (`lr2rmats.polish.host_dp`)."""
    out: List[Optional[tuple]] = [None] * len(items)
    todo = []
    n_host = 0
    with span("lr2rmats.polish.windows"):
        for t, (qwin, L0, R0, don, acc) in enumerate(items):
            m = len(qwin)
            DL = don - L0
            DR = R0 - 1 - acc
            if DL < 0 or DR < 0 or DL > m + B or DR > m + B:
                continue                               # infeasible: None
            if m > _PLACE_M or (R0 - L0) < m + B:
                n_host += 1
                out[t] = _constrained_place(qwin, ref, L0, R0, don, acc)
                continue
            todo.append(t)
    if not todo:
        count("lr2rmats.polish.host_dp", n_host)
        return out
    if device is None:
        with span("lr2rmats.polish.place"):
            for t in todo:
                qwin, L0, R0, don, acc = items[t]
                out[t] = _constrained_place(qwin, ref, L0, R0, don, acc)
        count("lr2rmats.polish.host_dp", n_host + len(todo))
        return out
    count("lr2rmats.polish.tasks", len(todo))
    with span("lr2rmats.polish.windows"):
        M = _PLACE_M
        G = -(-len(todo) // _PLACE_G) * _PLACE_G
        # int8 lanes: genome/read codes are 0..4 and PAD=-9
        PAD = np.int8(-9)
        q = np.full((M, G), PAD, np.int8)
        qr = np.full((M, G), PAD, np.int8)
        lwin = np.full((M + B, G), PAD, np.int8)
        rwin = np.full((M + B, G), PAD, np.int8)
        m_arr = np.zeros(G, np.int32)
        dl_arr = np.zeros(G, np.int32)
        dr_arr = np.zeros(G, np.int32)
        for g, t in enumerate(todo):
            qwin, L0, R0, don, acc = items[t]
            m = len(qwin)
            side = m + B                                # span >= m+B here
            q[:m, g] = qwin
            qr[:m, g] = qwin[::-1]
            lwin[:side, g] = ref[L0: L0 + side]
            rwin[:side, g] = ref[R0 - side: R0][::-1]
            m_arr[g] = m
            dl_arr[g] = don - L0
            dr_arr[g] = R0 - 1 - acc
    with span("lr2rmats.polish.place"):
        dev = torch.device(device)
        args = [torch.from_numpy(a).to(dev) for a in
                (q, qr, lwin, rwin, m_arr, dl_arr, dr_arr)]
        rows = place_lanes(*args).cpu().numpy()
        R = trace_runs(M)
        for g, t in enumerate(todo):
            out[t] = _traced(rows[g], R)
    count("lr2rmats.polish.host_dp", n_host)
    return out


def _pair_scores(pos, ops, q, op_i, don, acc, wd, wa, off,
                 ref: np.ndarray):
    """(own_score, alt_score) of the record's junction window under its own
    placement (don, acc) vs the alternative (wd, wa); None if the
    alternative is infeasible for this read."""
    ops2, op_i, q0, r0, lo, hi, q1, r1 = _window(
        ops, op_i, pos,
        FLANK_Q + max(wd - don, 0), FLANK_Q + max(acc - wa, 0))
    qwin = q[q0: q1]
    L0, R0 = off + r0, off + r1
    res = _constrained_place(qwin, ref, L0, R0, off + wd, off + wa)
    if res is None:
        return None
    own_sc, _, _ = _window_score(ops2, lo, hi, q, q0, ref, L0)
    b_own = _motif_bonus(ref, off + don, off + acc)[0]
    b_alt = _motif_bonus(ref, off + wd, off + wa)[0]
    return own_sc + b_own, res[0] + b_alt


class _Holders:
    """Lazy (tid, don, acc) -> junction-row-indices lookup over mapped
    records (secondaries included).  Only a handful of keys (tie pairs +
    consensus winners) are ever queried, so instead of materializing a
    dict of every junction group (~8 us/group — the polish hot spot at
    batch scale), keep the rows lexsorted and answer each get() with a
    three-level binary search."""

    def __init__(self, t, d, a, rows):
        order = np.lexsort((a, d, t))
        self.t, self.d, self.a = t[order], d[order], a[order]
        self.rows = rows[order]

    def get(self, key, default=()):
        t, d, a = key
        lo = int(np.searchsorted(self.t, t, "left"))
        hi = int(np.searchsorted(self.t, t, "right"))
        lo2 = lo + int(np.searchsorted(self.d[lo:hi], d, "left"))
        hi2 = lo + int(np.searchsorted(self.d[lo:hi], d, "right"))
        lo3 = lo2 + int(np.searchsorted(self.a[lo2:hi2], a, "left"))
        hi3 = lo2 + int(np.searchsorted(self.a[lo2:hi2], a, "right"))
        return self.rows[lo3:hi3] if hi3 > lo3 else default


def _holders_index(rb: RecordBatch, jt: dict):
    """Lazy holders lookup + the mapped-junction row mask."""
    j, rj = jt["j"], jt["rj"]
    m = np.nonzero((rb.flag[rj] & FUNMAP) == 0)[0]
    if not len(m):
        return _Holders(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.int64), m), m
    return _Holders(rb.tid[rj[m]].astype(np.int64), jt["don"][m],
                    jt["acc"][m], m), m


def _resolve_weight_ties(rb: RecordBatch, jt: dict, holders,
                         genome_codes, chrom_offsets, support,
                         winners) -> None:
    """Resolve equal-weight junction pairs by summed read evidence.

    When a misplaced junction and the true one tie on vote weight (e.g. a
    1-clean-read vs 1-errored-read gene), neither wins by count.  The
    likelihood vote decides instead: score every supporting read's window
    under BOTH placements and pick the placement with the larger summed
    score — the misplaced read barely prefers its junction while a clean
    sibling strongly prefers truth.  Losers are added to `winners`.
    """
    rj, opi = jt["rj"], jt["opi"]
    ops_cache: Dict[int, list] = {}
    q_cache: Dict[int, np.ndarray] = {}
    by_tid: Dict[int, List[Tuple[int, int, int]]] = {}
    for (tid, d, a), c in support.items():
        by_tid.setdefault(tid, []).append((d, a, c))
    for tid, rows in by_tid.items():
        rows.sort()
        dons = np.array([r[0] for r in rows], np.int64)
        off = int(chrom_offsets[tid])
        # vectorized candidate prefilter: only junctions with a SNAP-window
        # neighbor can tie (two per-row searchsorteds -> two array calls)
        lo_all = np.searchsorted(dons, dons - SNAP)
        hi_all = np.searchsorted(dons, dons + SNAP, side="right")
        for i in np.nonzero(hi_all - lo_all > 1)[0]:
            d, a, c = rows[i]
            if (tid, d, a) in winners:
                continue
            lo, hi = int(lo_all[i]), int(hi_all[i])
            for t in range(lo, hi):
                d2, a2, c2 = rows[t]
                if (d2, a2) <= (d, a) or abs(a2 - a) > SNAP or c2 != c:
                    continue
                if (tid, d2, a2) in winners:
                    continue
                total = 0.0        # > 0 prefers (d2, a2)
                ok = True
                for own, alt, sign in (((d, a), (d2, a2), -1.0),
                                       ((d2, a2), (d, a), +1.0)):
                    for row in holders.get((tid,) + own, ()):
                        ri = int(rj[row])
                        if ri not in q_cache:
                            q_cache[ri] = rb.seq_codes(ri)
                            ops_cache[ri] = _cigar_ops(rb.cigar(ri))
                        s = _pair_scores(int(rb.pos[ri]), ops_cache[ri],
                                         q_cache[ri], int(opi[row]),
                                         own[0], own[1], alt[0], alt[1],
                                         off, genome_codes)
                        if s is None:
                            ok = False
                            break
                        total += sign * (s[0] - s[1])
                    if not ok:
                        break
                if not ok or total == 0.0:
                    continue
                if total > 0:
                    winners[(tid, d, a)] = (tid, d2, a2)
                else:
                    winners[(tid, d2, a2)] = (tid, d, a)


def _set_cigars(rb: RecordBatch, new: Dict[int, np.ndarray]) -> None:
    """Replace the CIGARs of records {i: codes} in one rebuild of the
    ragged buffer: a rebuild a record costs O(total) each time, ~1000
    times a deep call."""
    if not new:
        return
    offs = rb.cig_offs
    counts = np.diff(offs)
    pieces, at = [], 0
    for i in sorted(new):
        pieces += [rb.cig_buf[at: offs[i]], new[i]]
        at = offs[i + 1]
        counts[i] = len(new[i])
    pieces.append(rb.cig_buf[at:])
    rb.cig_buf = np.concatenate(pieces).astype(np.uint32, copy=False)
    rb.cig_offs = np.concatenate([[0], np.cumsum(counts)]).astype(offs.dtype)


def polish_batch(rb: RecordBatch, genome_codes: np.ndarray,
                 chrom_offsets: np.ndarray, device=None,
                 changed_out: Optional[list] = None) -> int:
    """Snap near-miss junctions to their cross-read consensus placement
    (reference polish.py:polish_batch with the placement DP on `device`;
    device=None keeps it on the host).

    Mutates the batch in place (CIGAR + NM/AS arrays); returns the number
    of junctions re-placed.  `changed_out` collects changed record
    indices."""
    with span("lr2rmats.polish.support"):
        jt = _junction_table(rb)
        count("lr2rmats.polish.junctions", len(jt["j"]))
        if not len(jt["j"]):
            return 0
        support = _support_batch(rb, jt, genome_codes, chrom_offsets)
        winners = consensus_winners(support)
        holders, _ = _holders_index(rb, jt)
    with span("lr2rmats.polish.ties"):
        _resolve_weight_ties(rb, jt, holders, genome_codes, chrom_offsets,
                             support, winners)
    count("lr2rmats.polish.winners", len(winners))
    if not winners:
        return 0
    rj, opi = jt["rj"], jt["opi"]
    # single-junction records run the forced placement batched on the
    # device; multi-junction records stay sequential (each accepted move
    # rewrites the op list the next window reads)
    batch_place: Dict[int, Optional[tuple]] = {}
    batch_ctx: Dict[int, tuple] = {}
    items = []
    with span("lr2rmats.polish.windows"):
        by_rec: Dict[int, List[Tuple[int, int, int]]] = {}
        for key, w in winners.items():
            for row in holders.get(key, ()):
                by_rec.setdefault(int(rj[row]), []).append(
                    (int(opi[row]), key[1], key[2]))
        singles = [ri for ri in sorted(by_rec) if len(by_rec[ri]) == 1]
        for ri in singles:
            op_i, don, acc = by_rec[ri][0]
            ops = _cigar_ops(rb.cigar(ri))
            off = int(chrom_offsets[rb.tid[ri]])
            q = rb.seq_codes(ri)
            tid = int(rb.tid[ri])
            _, wd, wa = winners[(tid, don, acc)]
            ops2, op_i2, q0, r0, lo, hi, q1, r1 = _window(
                ops, op_i, int(rb.pos[ri]),
                FLANK_Q + max(wd - don, 0), FLANK_Q + max(acc - wa, 0))
            qwin = q[q0: q1]
            batch_ctx[ri] = (ops2, op_i2, q0, r0, lo, hi, q1, r1, q)
            items.append((qwin, off + r0, off + r1, off + wd, off + wa))
    count("lr2rmats.polish.tried", sum(map(len, by_rec.values())))
    if items:
        batch_place = dict(zip(singles, constrained_place_many(
            items, genome_codes, device)))
    n_fix = n_host = 0
    new_cigars: Dict[int, np.ndarray] = {}
    with span("lr2rmats.polish.accept"):
        for ri in sorted(by_rec):
            todo = sorted(by_rec[ri])
            off = int(chrom_offsets[rb.tid[ri]])
            tid = int(rb.tid[ri])
            if ri in batch_ctx:
                ops, op_i, q0, r0, lo, hi, q1, r1, q = batch_ctx[ri]
            else:
                ops = _cigar_ops(rb.cigar(ri))
                q = rb.seq_codes(ri)
            pos = int(rb.pos[ri])
            changed = False
            # re-place junctions right to left so op indices stay valid
            for op_i_t, don, acc in reversed(todo):
                _, wd, wa = winners[(tid, don, acc)]
                if ri in batch_ctx:
                    res = batch_place[ri]
                    ops, op_i = batch_ctx[ri][0], batch_ctx[ri][1]
                    q0, r0, lo, hi, q1, r1 = batch_ctx[ri][2:8]
                else:
                    # a junction shift must be absorbed by one flank's
                    # window
                    ops, op_i, q0, r0, lo, hi, q1, r1 = _window(
                        ops, op_i_t, pos, FLANK_Q + max(wd - don, 0),
                        FLANK_Q + max(acc - wa, 0))
                    res = None
                qwin = q[q0: q1]
                L0, R0 = off + r0, off + r1
                gd, ga = off + wd, off + wa
                if ri not in batch_ctx:
                    n_host += 1
                    res = _constrained_place(qwin, genome_codes, L0, R0,
                                             gd, ga)
                if res is None:
                    continue
                new_sc, lops, rops, new_match, new_nm = res
                old_sc, old_match, old_nm = _window_score(
                    ops, lo, hi, q, q0, genome_codes, L0)
                bonus_old = _motif_bonus(genome_codes, off + don,
                                         off + acc)[0]
                bonus_new, _ = _motif_bonus(genome_codes, gd, ga)
                own_w = support.get((tid, don, acc), 1)
                win_w = support.get((tid, wd, wa), 0)
                delta = DELTA_STRONG if win_w >= 2 * own_w + 2 else DELTA
                if new_sc + bonus_new < old_sc + bonus_old - delta:
                    continue
                new_seg = [(op, l) for op, l in lops if l > 0]
                new_seg.append((OP_N, wa - wd + 1))
                new_seg += [(op, l) for op, l in rops if l > 0]
                merged: List[Tuple[int, int]] = []
                for op, l in ops[:lo] + new_seg + ops[hi + 1:]:
                    if merged and merged[-1][0] == op:
                        merged[-1] = (op, merged[-1][1] + l)
                    else:
                        merged.append((op, l))
                ops = merged
                # NM/AS deltas (aligner convention: AS = 2*nmatch - 4*ed)
                rb.nm[ri] += new_nm - old_nm
                rb.score[ri] += (2 * (new_match - old_match)
                                 - 4 * (new_nm - old_nm))
                changed = True
                n_fix += 1
            if changed:
                new_cigars[ri] = np.array([(l << 4) | op for op, l in ops
                                           if l > 0], np.uint32)
                if changed_out is not None:
                    changed_out.append(ri)
        # each record reads only its own CIGAR, before its own rewrite
        _set_cigars(rb, new_cigars)
    count("lr2rmats.polish.host_dp", n_host)
    count("lr2rmats.polish.replaced", n_fix)
    return n_fix


def polish_records(records: List[AlnRec], genome_codes: np.ndarray,
                   chrom_offsets: np.ndarray) -> int:
    """AlnRec-list bridge over `polish_batch` (mutates records in place;
    returns the number of junctions re-placed)."""
    rb = RecordBatch.from_alnrecs(records)
    changed: list = []
    n = polish_batch(rb, genome_codes, chrom_offsets, changed_out=changed)
    for i in changed:
        rec = records[i]
        rec.cigar = rb.cigar(i).copy()
        if "NM" in rec.tags:
            rec.tags["NM"] = int(rb.nm[i])
        if "AS" in rec.tags:
            rec.tags["AS"] = int(rb.score[i])
    return n
