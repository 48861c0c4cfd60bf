"""Long-read spliced aligner: seed -> chain -> splice-aware extend.

Replaces the minimap2 role (`minimap2 -ax splice -ub`, reference
Snakefile:61).  Seeding uses the sorted minimizer index; chaining is the
splice-aware window DP (align.chain; batched device version in ops.chain);
extension merges colinear anchors into exon blocks, places introns with
motif-scored splice refinement (align.splice), fills intra-exon indel gaps
with banded DP, and emits SAM records carrying the tags the downstream
filter consumes (NM / AS / XS / NH — reference bam_filter.c:79, bam2seg
parse_bam.c:548-551, gen_exon bam2gtf.c:35).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..io.fasta import Genome, SeqSet, revcomp, decode_seq
from ..io.sam import (AlnRec, FREVERSE, FSECONDARY, OP_D, OP_I, OP_M, OP_N,
                      OP_S)
from ..index.minimizer import MinimizerIndex, extract_minimizers
from ..utils import log
from .banded import banded_edit_path
from .chain import ChainParams, backtrack, chain_anchors
from .splice import BONUS_CANON, W_POS, refine_splice, refine_splice_indel


@dataclass
class AlignParams:
    k: int = 15
    w: int = 5
    chain: ChainParams = field(default_factory=ChainParams)
    max_anchors: int = 5000       # per read/strand cap
    min_intron_gap: int = 30      # ref-excess beyond which a gap is an intron
    min_intron_len: int = 30      # shortest intron the extender will emit
    band_pad: int = 16
    ext_match: int = 1
    ext_mismatch: int = 4         # end-extension drop-off X penalty
    min_score: float = 20.0


class SpliceAligner:
    def __init__(self, genome: Genome, params: Optional[AlignParams] = None,
                 index: Optional[MinimizerIndex] = None):
        self.genome = genome
        self.p = params or AlignParams()
        self.p.chain.k = self.p.k
        self.index = index or MinimizerIndex.build(genome, self.p.k, self.p.w)
        self.refs = [(n, int(l)) for n, l in zip(genome.names, genome.lengths())]

    # ------------------------------------------------------------- seeding
    def _anchors(self, codes: np.ndarray):
        """Anchor lists for both orientations.

        Returns dict strand -> (qpos, gpos) with qpos in the coordinate
        system of the (possibly reverse-complemented) query that matches the
        forward genome.
        """
        p = self.p
        L = len(codes)
        h, qpos, qstrand = extract_minimizers(codes, p.k, p.w)
        lo, hi = self.index.lookup(h)
        cnt = hi - lo
        keep = cnt > 0
        out = {0: None, 1: None}
        if not keep.any():
            return out
        idx = np.nonzero(keep)[0]
        # expand hit ranges
        reps = cnt[idx]
        qp = np.repeat(qpos[idx], reps)
        qs = np.repeat(qstrand[idx], reps)
        flat = np.concatenate([np.arange(lo[i], hi[i]) for i in idx])
        gp = self.index.pos[flat]
        gs = self.index.strand[flat]
        strand = (qs ^ gs).astype(np.int8)
        for s in (0, 1):
            m = strand == s
            if not m.any():
                continue
            q = qp[m]
            g = gp[m]
            if s == 1:  # anchor position in RC-read coordinates
                q = L - p.k - q
            order = np.lexsort((q, g))
            q, g = q[order], g[order]
            if len(q) > p.max_anchors:
                sub = np.linspace(0, len(q) - 1, p.max_anchors).astype(np.int64)
                q, g = q[sub], g[sub]
            out[s] = (q.astype(np.int64), g.astype(np.int64))
        return out

    # ----------------------------------------------------------- extension
    def _merge_chain_blocks(self, q: np.ndarray, g: np.ndarray):
        """Chain anchors -> colinear blocks [(q0, g0, blen)...].

        Anchors on the same diagonal extend the current block; an anchor on a
        new diagonal that overlaps the current block (k-mer span crossing the
        block end) is trimmed from the left, and dropped entirely if the trim
        consumes it.
        """
        k = self.p.k
        blocks = []
        q0, g0 = int(q[0]), int(g[0])
        qe, ge = q0 + k, g0 + k
        for i in range(1, len(q)):
            qi, gi = int(q[i]), int(g[i])
            if qi - q0 == gi - g0:  # same diagonal: extend
                qe = max(qe, qi + k)
                ge = max(ge, gi + k)
                continue
            d = max(qe - qi, ge - gi)  # overlap with current block
            if d > 0:
                if d >= k:
                    continue  # fully consumed by the trim
                qi += d
                gi += d
            blocks.append((q0, g0, qe - q0))
            q0, g0 = qi, gi
            qe, ge = qi + (k - max(d, 0) if d > 0 else k), gi + (k - max(d, 0) if d > 0 else k)
        blocks.append((q0, g0, qe - q0))
        return blocks

    def _extend(self, codes: np.ndarray, q: np.ndarray, g: np.ndarray):
        """Build (pos, cigar, NM, nmatch, splice_vote) from chain anchors
        over the concatenated genome buffer.

        Dispatches to the native one-call kernel when available (bit-equal;
        tests/test_native.py::test_extend_chain_match)."""
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            res = self._extend_native(lib, codes, q, g)
        else:
            res = self._extend_py(codes, q, g)
        return self._rescue_terminal_exons(codes, res)

    def _rescue_terminal_exons(self, codes: np.ndarray, res, pre=None):
        """Place large soft-clips as spliced terminal exons.

        A read whose first/last exon had no anchors ends up soft-clipped;
        minimap2 recovers such exons during DP.  Here: seed the clipped
        sequence against the index within max_intron of the alignment edge,
        and if a colinear block is found, join it with the indel-aware
        junction DP (motif-scored), extending the CIGAR with exon + N.

        `pre` optionally carries batch-precomputed clip seeds
        {"lead"/"trail": (h, qp, qs, lo, hi)} so the batch path pays ONE
        native minimizer extraction + ONE index lookup per batch instead
        of two python calls per rescued read (batch.py
        _packed_from_extension).
        """
        p = self.p
        pos, ops, ed, nmatch, vote = res
        if not ops:
            return res
        MIN_RESCUE = p.k + p.w + 4  # need at least one minimizer
        ref = self.genome.codes

        def _seed_clip(clip_codes, lo_g, hi_g, seeds=None):
            """Best colinear block of the clip within ref window [lo_g, hi_g);
            returns (qpos, gpos) arrays or None.  The clip is already in
            aligned-read orientation, so only forward-strand matches
            (index strand == query minimizer strand) count."""
            if seeds is not None:
                h, qp, qs, lo, hi = seeds
                if not len(h):
                    return None
            else:
                h, qp, qs = extract_minimizers(clip_codes, p.k, p.w)
                if not len(h):
                    return None
                lo, hi = self.index.lookup(h)
            cnt = (hi - lo).astype(np.int64)
            keep = (cnt > 0) & (cnt <= 16)   # drop repetitive seeds
            if not keep.any():
                return None
            lo, cnt = lo[keep], cnt[keep]
            qpk = np.asarray(qp, np.int64)[keep]
            qsk = np.asarray(qs)[keep]
            total = int(cnt.sum())
            starts = np.zeros(len(cnt) + 1, np.int64)
            np.cumsum(cnt, out=starts[1:])
            rep = np.repeat(np.arange(len(cnt)), cnt)
            flat = np.repeat(lo, cnt) + (np.arange(total) -
                                         np.repeat(starts[:-1], cnt))
            gp_all = self.index.pos[flat].astype(np.int64)
            m = ((self.index.strand[flat] == qsk[rep]) &
                 (gp_all >= lo_g) & (gp_all < hi_g))
            if not m.any():
                return None
            cq = qpk[rep[m]]
            cg = gp_all[m]
            order = np.lexsort((cq, cg))
            cq, cg = cq[order], cg[order]
            # keep the most-supported diagonal
            diag = cg - cq
            vals, counts = np.unique(diag, return_counts=True)
            best_d = vals[int(np.argmax(counts))]
            m = diag == best_d
            if int(counts.max()) < 2:
                return None
            return cq[m], cg[m]

        # ---- leading clip
        chrom_lo, chrom_hi = self._chrom_bounds(pos)
        if ops[0][0] == OP_S and ops[0][1] >= MIN_RESCUE:
            c = ops[0][1]
            clip = codes[:c]
            hit = _seed_clip(clip, max(chrom_lo, pos - p.chain.max_intron),
                             pos, seeds=pre.get("lead") if pre else None)
            if hit is not None:
                cq, cg = hit
                exon_g0 = int(cg[0] - cq[0])          # diagonal placement
                exon_len0 = int(cq[-1]) + p.k          # covered clip prefix
                gap_q = c - exon_len0                  # unaligned clip middle
                left_end_g = exon_g0 + exon_len0
                if 0 <= gap_q and pos - left_end_g - gap_q >= p.min_intron_len \
                        and exon_g0 >= chrom_lo:
                    r2 = refine_splice_indel(
                        codes[exon_len0: c], ref, left_end_g, pos,
                        min_intron=p.min_intron_len)
                    if r2 is not None and r2[4] > 0:
                        lops, intron, rops, v, _ = r2
                        mism = int(np.sum(codes[:exon_len0] !=
                                          ref[exon_g0: exon_g0 + exon_len0]))
                        # reject a too-noisy lead placement but
                        # still try the TRAILING clip below (an
                        # early return here silently dropped the
                        # other terminal exon)
                        if mism <= 0.25 * exon_len0:
                            new_ops = [(OP_M, exon_len0)]
                            new_ops += lops + [(OP_N, intron)] + rops
                            # merge with the remaining ops (drop the S)
                            rest = ops[1:]
                            merged = list(new_ops)
                            for op, l in rest:
                                if merged and merged[-1][0] == op:
                                    merged[-1] = (op, merged[-1][1] + l)
                                else:
                                    merged.append((op, l))
                            ops = merged
                            pos = exon_g0
                            # count mismatches inside the junction-DP M runs too
                            gm = 0
                            qi, gi = exon_len0, left_end_g
                            for op, l in lops:
                                if op == OP_M:
                                    gm += int(np.sum(codes[qi: qi + l] !=
                                                     ref[gi: gi + l]))
                                    qi += l; gi += l
                                elif op == OP_I:
                                    qi += l
                                else:
                                    gi += l
                            gi += intron
                            for op, l in rops:
                                if op == OP_M:
                                    gm += int(np.sum(codes[qi: qi + l] !=
                                                     ref[gi: gi + l]))
                                    qi += l; gi += l
                                elif op == OP_I:
                                    qi += l
                                else:
                                    gi += l
                            ed += mism + gm + sum(l for op, l in lops + rops
                                                  if op in (OP_I, OP_D))
                            nmatch += exon_len0 - mism
                            vote += v
        # ---- trailing clip
        if ops and ops[-1][0] == OP_S and ops[-1][1] >= MIN_RESCUE:
            c = ops[-1][1]
            L = len(codes)
            qstart = L - c
            ref_end = pos + sum(l for op, l in ops
                                if op in (OP_M, OP_D, OP_N))
            hit = _seed_clip(codes[qstart:], ref_end,
                             min(chrom_hi, ref_end + p.chain.max_intron),
                             seeds=pre.get("trail") if pre else None)
            if hit is not None:
                cq, cg = hit
                exon_gs = int(cg[0] - cq[0])           # diagonal
                exon_q0 = int(cq[0])                   # first covered clip base
                exon_len0 = c - exon_q0                # exon part to read end
                if (exon_gs + exon_q0) - ref_end >= p.min_intron_len and \
                        exon_gs + c <= chrom_hi:
                    r2 = refine_splice_indel(
                        codes[qstart: qstart + exon_q0], ref, ref_end,
                        exon_gs + exon_q0, min_intron=p.min_intron_len)
                    if r2 is not None and r2[4] > 0:
                        lops, intron, rops, v, _ = r2
                        gs = exon_gs + exon_q0
                        mism = int(np.sum(codes[qstart + exon_q0:] !=
                                          ref[gs: gs + exon_len0]))
                        if mism > 0.25 * exon_len0:
                            return pos, ops, ed, nmatch, vote
                        ops = ops[:-1]
                        for op, l in lops + [(OP_N, intron)] + rops + \
                                [(OP_M, exon_len0)]:
                            if ops and ops[-1][0] == op:
                                ops[-1] = (op, ops[-1][1] + l)
                            else:
                                ops.append((op, l))
                        gm = 0
                        qi, gi = qstart, ref_end
                        for op, l in lops:
                            if op == OP_M:
                                gm += int(np.sum(codes[qi: qi + l] !=
                                                 ref[gi: gi + l]))
                                qi += l; gi += l
                            elif op == OP_I:
                                qi += l
                            else:
                                gi += l
                        # right flank ends at gs; walk it from its start
                        r_ref = sum(l for op, l in rops if op in (OP_M, OP_D))
                        gi = gs - r_ref
                        for op, l in rops:
                            if op == OP_M:
                                gm += int(np.sum(codes[qi: qi + l] !=
                                                 ref[gi: gi + l]))
                                qi += l; gi += l
                            elif op == OP_I:
                                qi += l
                            else:
                                gi += l
                        ed += mism + gm + sum(l for op, l in lops + rops
                                              if op in (OP_I, OP_D))
                        nmatch += exon_len0 - mism
                        vote += v
        return pos, ops, ed, nmatch, vote

    def _chrom_bounds(self, gpos0: int):
        t = int(np.searchsorted(self.index.chrom_offsets, gpos0,
                                side="right") - 1)
        return (int(self.index.chrom_offsets[t]),
                int(self.index.chrom_offsets[t + 1]))

    def _extend_native(self, lib, codes: np.ndarray, q: np.ndarray,
                       g: np.ndarray):
        import ctypes
        p = self.p
        L = len(codes)
        chrom_lo, chrom_hi = self._chrom_bounds(int(g[0]))
        cap = 2 * (L + 64)
        ops_buf = np.zeros(2 * cap, np.int32)
        n_ops = ctypes.c_int32(cap)
        pos = ctypes.c_int64()
        ed = ctypes.c_int64()
        nmatch = ctypes.c_int64()
        vote = ctypes.c_int32()
        rc = lib.extend_chain_c(
            np.ascontiguousarray(codes, np.uint8), L,
            self.genome.codes, len(self.genome.codes),
            chrom_lo, chrom_hi,
            np.ascontiguousarray(q, np.int64),
            np.ascontiguousarray(g, np.int64), len(q),
            p.k, p.min_intron_gap, p.min_intron_len, p.band_pad,
            p.ext_match, p.ext_mismatch, 4,
            ctypes.byref(pos), ops_buf, ctypes.byref(n_ops),
            ctypes.byref(ed), ctypes.byref(nmatch), ctypes.byref(vote))
        if rc != 0:
            return self._extend_py(codes, q, g)
        ops = [(int(ops_buf[2 * i]), int(ops_buf[2 * i + 1]))
               for i in range(n_ops.value)]
        return (int(pos.value), ops, int(ed.value), int(nmatch.value),
                int(vote.value))

    def _extend_py(self, codes: np.ndarray, q: np.ndarray, g: np.ndarray):
        p = self.p
        chrom_lo, chrom_hi = self._chrom_bounds(int(g[0]))
        ref = self.genome.codes
        L = len(codes)
        blocks = [list(b) for b in self._merge_chain_blocks(q, g)]
        # pull anchor-block edges back into intron gaps so the junction DP
        # can move the splice point into exactly-matching flank sequence;
        # the per-gap (El, Er) is kept as the junction prior center (the
        # anchor-implied donor/acceptor offsets into the gap — splice.W_POS)
        E = 6
        eler = {}
        for i in range(1, len(blocks)):
            pq, pg, pl = blocks[i - 1]
            bq, bg, bl = blocks[i]
            gq = bq - (pq + pl)
            gg = bg - (pg + pl)
            if gg - gq >= p.min_intron_gap:
                El = min(E, pl - 8) if pl > 8 else 0
                Er = min(E, bl - 8) if bl > 8 else 0
                blocks[i - 1][2] -= El
                blocks[i][0] += Er
                blocks[i][1] += Er
                blocks[i][2] -= Er
                eler[i] = (El, Er)
        ops: List[Tuple[int, int]] = []
        ed = 0
        nmatch = 0
        vote = 0

        def push(op: int, l: int):
            if l <= 0:
                return
            if ops and ops[-1][0] == op:
                ops[-1] = (op, ops[-1][1] + l)
            else:
                ops.append((op, l))

        def count_m(qs: int, gs: int, l: int):
            nonlocal ed, nmatch
            if l <= 0:
                return
            mism = int(np.sum(codes[qs: qs + l] != ref[gs: gs + l]))
            ed += mism
            nmatch += l - mism

        def emit_ops(sub_ops, qi: int, gi: int):
            """Push (op,len) runs, counting NM/matches; returns ref consumed."""
            nonlocal ed
            g_used = 0
            for op, l in sub_ops:
                push(op, l)
                if op == OP_M:
                    count_m(qi, gi + g_used, l)
                    qi += l
                    g_used += l
                elif op == OP_I:
                    qi += l
                    ed += l
                elif op == OP_D:
                    g_used += l
                    ed += l
                elif op == OP_N:
                    g_used += l
            return g_used

        # ---- left end extension (no-indel drop-off; never crosses the
        # chromosome boundary in the concatenated buffer)
        q0, g0, _ = blocks[0]
        ext = min(q0, g0 - chrom_lo)
        if ext > 0:
            a = codes[q0 - ext: q0]
            b = ref[g0 - ext: g0]
            match = (a == b)[::-1]  # from the anchor outward
            sc = np.cumsum(np.where(match, p.ext_match, -p.ext_mismatch))
            best = int(np.argmax(sc))
            take = best + 1 if sc[best] > 0 else 0
        else:
            take = 0
        lead_clip = q0 - take
        pos = g0 - take
        push(OP_S, lead_clip)
        if take:
            push(OP_M, take)
            count_m(q0 - take, g0 - take, take)

        # ---- blocks + gaps
        for bi, (bq, bg, blen) in enumerate(blocks):
            if bi > 0:
                pq, pg, pl = blocks[bi - 1]
                gap_q = bq - (pq + pl)
                gap_g = bg - (pg + pl)
                if gap_q < 0 or gap_g < 0:
                    # shouldn't happen after merge; fall back to skipping
                    gap_q = max(gap_q, 0)
                    gap_g = max(gap_g, 0)
                if (gap_g - gap_q >= p.min_intron_gap and
                        gap_g - gap_q >= p.min_intron_len):
                    qgap = codes[pq + pl: bq]
                    el, er = eler.get(bi, (0, 0))
                    # fast path: clean split (all gap bases match, canonical
                    # motif) needs no indel DP; the threshold discounts the
                    # minimum achievable prior penalty
                    j, fsc, v = refine_splice(qgap, ref, pg + pl, bg, el, er)
                    if fsc >= (len(qgap) + BONUS_CANON
                               - W_POS * max(el + er - len(qgap), 0)):
                        vote += v
                        intron = gap_g - gap_q
                        if j:
                            push(OP_M, j)
                            count_m(pq + pl, pg + pl, j)
                        push(OP_N, intron)
                        rest = gap_q - j
                        if rest:
                            push(OP_M, rest)
                            count_m(pq + pl + j, bg - rest, rest)
                        push(OP_M, blen)
                        count_m(bq, bg, blen)
                        continue
                    res = refine_splice_indel(qgap, ref, pg + pl, bg,
                                              min_intron=p.min_intron_len,
                                              el_exp=el, er_exp=er)
                    if res is not None:
                        left_ops, intron, right_ops, v, _ = res
                        vote += v
                        g_used = emit_ops(left_ops, pq + pl, pg + pl)
                        push(OP_N, intron)
                        emit_ops(right_ops, pq + pl + sum(
                            l for op, l in left_ops if op in (OP_M, OP_I)),
                            pg + pl + g_used + intron)
                    else:  # no valid intron: banded gap fill
                        emit_ops(banded_edit_path(
                            codes[pq + pl: bq], ref[pg + pl: bg],
                            p.band_pad)[0], pq + pl, pg + pl)
                elif gap_q == gap_g:
                    push(OP_M, gap_q)
                    count_m(pq + pl, pg + pl, gap_q)
                else:
                    emit_ops(banded_edit_path(
                        codes[pq + pl: bq], ref[pg + pl: bg], p.band_pad)[0],
                        pq + pl, pg + pl)
            push(OP_M, blen)
            count_m(bq, bg, blen)

        # ---- right end extension
        lq, lg, ll = blocks[-1]
        qend, gend = lq + ll, lg + ll
        rem = L - qend
        ext = min(rem, chrom_hi - gend)
        if ext > 0:
            a = codes[qend: qend + ext]
            b = ref[gend: gend + ext]
            match = a == b
            sc = np.cumsum(np.where(match, p.ext_match, -p.ext_mismatch))
            best = int(np.argmax(sc))
            take = best + 1 if sc[best] > 0 else 0
        else:
            take = 0
        if take:
            push(OP_M, take)
            count_m(qend, gend, take)
        push(OP_S, L - qend - take)
        return pos, ops, ed, nmatch, vote

    # ------------------------------------------------------------ top level
    def align_read(self, name: str, codes: np.ndarray) -> List[AlnRec]:
        p = self.p
        anchors = self._anchors(codes)
        rc = revcomp(codes)
        cands = []  # (score, strand, chain_q, chain_g)
        for s in (0, 1):
            if anchors[s] is None:
                continue
            q, g = anchors[s]
            # chains must not cross chromosome boundaries in the
            # concatenated buffer: chain per chrom group
            atid = np.searchsorted(self.index.chrom_offsets, g,
                                   side="right") - 1
            for t in np.unique(atid):
                m = atid == t
                qt, gt = q[m], g[m]
                if len(qt) < 2:
                    continue
                f, parent = chain_anchors(qt, gt, p.chain)
                pri, ps, sec, ss = backtrack(f, parent, p.min_score)
                if len(pri):
                    cands.append((ps, s, qt[pri], gt[pri]))
                if len(sec):
                    cands.append((ss, s, qt[sec], gt[sec]))
        if not cands:
            return []
        cands.sort(key=lambda c: -c[0])
        recs: List[AlnRec] = []
        for rank, (score, s, cq, cg) in enumerate(cands[:2]):
            seq_codes = rc if s == 1 else codes
            pos_g, ops, ed, nmatch, vote = self._extend(seq_codes, cq, cg)
            if nmatch < p.min_score:
                continue
            tid, pos = self.index.global_to_chrom(np.array([pos_g]))
            tid, pos = int(tid[0]), int(pos[0])
            flag = (FREVERSE if s == 1 else 0) | (FSECONDARY if rank else 0)
            cigar = np.array([(l << 4) | op for op, l in ops if l > 0],
                             np.uint32)
            tags = {"NM": ed, "AS": int(2 * nmatch - 4 * ed), "NH": len(cands[:2])}
            has_intron = any(op == OP_N for op, _ in ops)
            if has_intron and vote != 0:
                tags["XS"] = "+" if vote > 0 else "-"
            recs.append(AlnRec(
                qname=name, flag=flag, tid=tid, pos=pos,
                mapq=0, cigar=cigar,
                seq=decode_seq(seq_codes), qual="*", tags=tags))
        from .mapq import MAPQ_UNIQUE, mapq_from_scores
        from .batch import BatchAligner
        mapq = (MAPQ_UNIQUE if len(cands) == 1 else
                mapq_from_scores(cands[0][0], cands[1][0]))
        return BatchAligner._apply_survivor_ranks(recs, mapq)

    def align_seqset(self, reads: SeqSet) -> Iterator[AlnRec]:
        for i in range(reads.n):
            yield from self.align_read(reads.names[i], reads.get(i))
