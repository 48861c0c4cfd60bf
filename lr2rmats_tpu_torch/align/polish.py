"""Cross-read splice-junction consensus polish, placement DP on the card.

Counterpart of lr2rmats_tpu/align/polish.py.  The support collection,
consensus winners, tie resolution, windows, traceback and CIGAR rewrite are
the reference's own host functions, imported unchanged; only the batched
forced-placement DP moves here:

  * `polish_best_pair` — both flank shift DPs (ops/splice.shift_dp, the
    kernel) plus the best-split reduction in torch ops on the same device,
    as the reference's `_polish_best_pair` does in XLA;
  * `constrained_place_many` — packs the tasks as the reference's
    `_constrained_place_many` does (int8 lanes, `_PLACE_M` rows, lanes
    padded to `_PLACE_G`) and returns ("defer", score) per batched task;
  * `polish_batch` — the reference's body with the port's placement.

Dropped with respect to the reference: the relay canary (a small first
call whose slowness routed the rest to the host), the `device_stats`
failure fallback and the host-DP switch.  A kernel failure raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lr2rmats_tpu.align.polish import (B, DELTA, DELTA_STRONG, FLANK_Q,
                                       _PLACE_G, _PLACE_M, _cigar_ops,
                                       _constrained_place, _holders_index,
                                       _junction_table, _resolve_weight_ties,
                                       _support_batch, _window,
                                       _window_score, consensus_winners)
from lr2rmats_tpu.align.records import RecordBatch
from lr2rmats_tpu.align.splice import NEG, _motif_bonus
from lr2rmats_tpu.io.sam import OP_N

from ..ops.splice import shift_dp


def polish_best_pair(q, qr, lwin, rwin, m, dl, dr, band: int = B
                     ) -> torch.Tensor:
    """Best forced-placement score per lane, [G] float32: the max over
    splits j <= m of SL[j, dl+band-j] + SR[m-j, dr+band-(m-j)], NEG where
    no split fits the band (reference polish.py:_polish_best_pair)."""
    SL = shift_dp(q, lwin, m, band)                  # [M+1, W, G]
    SR = shift_dp(qr, rwin, m, band)
    M1, W, G = SL.shape
    dev = SL.device
    j = torch.arange(M1, dtype=torch.int64, device=dev)[:, None]
    m64, dl64, dr64 = (t.to(torch.int64)[None, :] for t in (m, dl, dr))
    cl = dl64 + band - j                             # [M1, G]
    cr = dr64 + band - (m64 - j)
    okj = (j <= m64) & (cl >= 0) & (cl < W) & (cr >= 0) & (cr < W)
    slj = SL.reshape(M1 * W, G).gather(0, j * W + cl.clamp(0, W - 1))
    mj = (m64 - j).clamp(0, M1 - 1)
    srj = SR.reshape(M1 * W, G).gather(0, mj * W + cr.clamp(0, W - 1))
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    return torch.where(okj, slj + srj, neg).max(0).values


def constrained_place_many(items: List[tuple], ref: np.ndarray,
                           device) -> List[Optional[tuple]]:
    """Reference `_constrained_place` over (qwin, L0, R0, don, acc) tasks.

    Infeasible tasks give None.  Tasks the batch cannot carry (window
    longer than _PLACE_M, span < m+B) run the host DP and give its full
    result.  The rest run one batched placement DP on `device` and give
    ("defer", score): only the score comes back, and polish_batch re-runs
    the host DP for the traceback of the placements it accepts."""
    out: List[Optional[tuple]] = [None] * len(items)
    todo = []
    for t, (qwin, L0, R0, don, acc) in enumerate(items):
        m = len(qwin)
        DL = don - L0
        DR = R0 - 1 - acc
        if DL < 0 or DR < 0 or DL > m + B or DR > m + B:
            continue                                   # infeasible: None
        if m > _PLACE_M or (R0 - L0) < m + B:
            out[t] = _constrained_place(qwin, ref, L0, R0, don, acc)
            continue
        todo.append(t)
    if not todo:
        return out
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
        side = m + B                                    # span >= m+B here
        q[:m, g] = qwin
        qr[:m, g] = qwin[::-1]
        lwin[:side, g] = ref[L0: L0 + side]
        rwin[:side, g] = ref[R0 - side: R0][::-1]
        m_arr[g] = m
        dl_arr[g] = don - L0
        dr_arr[g] = R0 - 1 - acc
    dev = torch.device(device)
    args = [torch.from_numpy(a).to(dev) for a in
            (q, qr, lwin, rwin, m_arr, dl_arr, dr_arr)]
    best = polish_best_pair(*args).cpu().numpy().astype(np.float64)
    for g, t in enumerate(todo):
        # the host split loop needs sc > NEG/2 to accept any j
        out[t] = ("defer", float(best[g])) if best[g] > NEG / 2 else None
    return out


def polish_batch(rb: RecordBatch, genome_codes: np.ndarray,
                 chrom_offsets: np.ndarray, device,
                 changed_out: Optional[list] = None) -> int:
    """Snap near-miss junctions to their cross-read consensus placement
    (reference polish.py:polish_batch with the placement DP on `device`).

    Mutates the batch in place (CIGAR + NM/AS arrays); returns the number
    of junctions re-placed."""
    jt = _junction_table(rb)
    if not len(jt["j"]):
        return 0
    support = _support_batch(rb, jt, genome_codes, chrom_offsets)
    winners = consensus_winners(support)
    holders, _ = _holders_index(rb, jt)
    _resolve_weight_ties(rb, jt, holders, genome_codes, chrom_offsets,
                         support, winners)
    if not winners:
        return 0
    rj, opi = jt["rj"], jt["opi"]
    by_rec: Dict[int, List[Tuple[int, int, int]]] = {}
    for key, w in winners.items():
        for row in holders.get(key, ()):
            by_rec.setdefault(int(rj[row]), []).append(
                (int(opi[row]), key[1], key[2]))
    n_fix = 0
    # single-junction records run the forced placement batched on the
    # device; multi-junction records stay sequential (each accepted move
    # rewrites the op list the next window reads)
    singles = [ri for ri in sorted(by_rec) if len(by_rec[ri]) == 1]
    batch_place: Dict[int, Optional[tuple]] = {}
    batch_ctx: Dict[int, tuple] = {}
    if singles:
        items = []
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
        for ri, res in zip(singles, constrained_place_many(
                items, genome_codes, device)):
            batch_place[ri] = res
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
                # a junction shift must be absorbed by one flank's window
                ops, op_i, q0, r0, lo, hi, q1, r1 = _window(
                    ops, op_i_t, pos,
                    FLANK_Q + max(wd - don, 0), FLANK_Q + max(acc - wa, 0))
                res = None
            qwin = q[q0: q1]
            L0, R0 = off + r0, off + r1
            gd, ga = off + wd, off + wa
            if ri not in batch_ctx:
                res = _constrained_place(qwin, genome_codes, L0, R0, gd, ga)
            if res is None:
                continue
            if res[0] == "defer":
                # the device returned the score only; decide acceptance
                # first and run the host traceback DP just for winners
                new_sc = res[1]
                lops = None
            else:
                new_sc, lops, rops, new_match, new_nm = res
            old_sc, old_match, old_nm = _window_score(ops, lo, hi, q, q0,
                                                      genome_codes, L0)
            bonus_old = _motif_bonus(genome_codes, off + don, off + acc)[0]
            bonus_new, _ = _motif_bonus(genome_codes, gd, ga)
            own_w = support.get((tid, don, acc), 1)
            win_w = support.get((tid, wd, wa), 0)
            delta = DELTA_STRONG if win_w >= 2 * own_w + 2 else DELTA
            if new_sc + bonus_new < old_sc + bonus_old - delta:
                continue
            if lops is None:
                res = _constrained_place(qwin, genome_codes, L0, R0, gd, ga)
                if res is None:
                    continue
                new_sc, lops, rops, new_match, new_nm = res
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
            rb.set_cigar(ri, np.array([(l << 4) | op for op, l in ops
                                       if l > 0], np.uint32))
            if changed_out is not None:
                changed_out.append(ri)
    return n_fix
