"""Long-read alignment filtering (the `filter` subcommand).

Per-read best-alignment selection from the long-read aligner's SAM
(reference bam_filter.c:98-164): coverage >= aln_cov, identity >= iden_frac,
second-best/best score < sec_rat, intron count >= min_intron_n, and removal
of reads overlapping rm_gtf (rRNA) transcripts.  Alignment records of one
read are assumed adjacent in the stream (aligner output order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np

from ..io.sam import AlnRec, OP_D, OP_N, OP_S, OP_H
from ..utils import log
from .model import Transcripts

COV_RATIO = 0.67   # reference bam_filter.c:10
MAP_QUAL = 0.75    # bam_filter.c:11
SEC_RATIO = 0.98   # bam_filter.c:12
MIN_INTRON_NUM = 0  # gtf.h:123


@dataclass
class FilterParams:
    cov_rate: float = COV_RATIO      # -v
    map_qual: float = MAP_QUAL       # -q
    sec_rat: float = SEC_RATIO       # -s
    min_intron_n: int = MIN_INTRON_NUM  # -i


class RmIndex:
    """Sorted interval index over the rm_gtf transcripts.

    Replaces the reference's per-record linear scan (bam_filter.c:49-59;
    O(records x rm) for a large rm_gtf) with a binary search over
    (tid, start)-sorted intervals plus a per-tid running max-end — O(log rm)
    per record with identical results for tid-sorted input (the only case
    the reference's early-exit scan handles deterministically anyway)."""

    def __init__(self, rm: Transcripts):
        n = rm.n
        tid = rm.tid[:n].astype(np.int64)
        start = rm.start[:n].astype(np.int64)
        end = rm.end[:n].astype(np.int64)
        order = np.lexsort((start, tid))
        tid, start, end = tid[order], start[order], end[order]
        self.n = n
        self.tid = tid
        self.key = (tid << np.int64(32)) | start
        maxend = end.copy()
        for i in range(1, n):            # per-tid running max (rm is small;
            if tid[i] == tid[i - 1]:     # this runs once per filter call)
                maxend[i] = max(maxend[i], maxend[i - 1])
        self.maxend = maxend

    def overlaps(self, tid: int, p0: int, p1: int) -> bool:
        """Any rm interval on `tid` intersecting [p0, p1]?"""
        if self.n == 0:
            return False
        j = int(np.searchsorted(self.key, (tid << 32) | (p1 + 1), "left"))
        if j == 0 or self.tid[j - 1] != tid:
            return False
        return bool(self.maxend[j - 1] >= p0)


def remove_overlap(rec: AlnRec, rm) -> bool:
    """Does the alignment overlap any rm_gtf transcript?
    (reference remove_overlap, bam_filter.c:49-59)."""
    if isinstance(rm, Transcripts):
        rm = RmIndex(rm)
    pos = rec.pos
    return rm.overlaps(int(rec.tid), pos, pos + rec.ref_len() - 1)


def gtf_filter(rec: AlnRec, params: FilterParams, rm):
    """Returns (keep: bool, score: int, intron_n: int)
    (reference gtf_filter, bam_filter.c:61-86)."""
    if rec.is_unmapped:
        return False, 0, 0
    c = rec.cigar
    ops = c & 0xF
    lens = (c >> 4).astype(np.int64)
    intron_n = int(np.sum(ops == OP_N))
    del_len = int(lens[ops == OP_D].sum())
    cigar_qlen = rec.l_qseq
    n_c = len(c)
    if n_c and ops[0] in (OP_S, OP_H):
        cigar_qlen -= int(lens[0])
    if n_c > 1 and ops[-1] in (OP_S, OP_H):
        cigar_qlen -= int(lens[-1])
    l_qseq = rec.l_qseq
    # (cigar_qlen+0.0)/l_qseq in C: 0/0 = nan which fails the `< cov_rate`
    # test (i.e. record passes); replicate IEEE semantics.
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = np.float64(cigar_qlen) / np.float64(l_qseq)
    if cov < params.cov_rate:
        return False, 0, intron_n
    ed = int(rec.tags.get("NM", 0))
    score = cigar_qlen - ed + del_len
    if score < params.map_qual * cigar_qlen:
        return False, 0, intron_n
    if remove_overlap(rec, rm):
        return False, 0, intron_n
    return True, score, intron_n


def filter_alignments(records: Iterable[AlnRec], params: FilterParams,
                      rm: Optional[Transcripts] = None) -> Iterator[AlnRec]:
    """Streaming best/second-best per-qname selection
    (reference bam_filter, bam_filter.c:130-159)."""
    if rm is None:
        rm = Transcripts(cap=1)
        rm.n = 0
    if isinstance(rm, Transcripts):
        rm = RmIndex(rm)
    lqname = None
    best: Optional[AlnRec] = None
    b_score = s_score = 0
    b_intron_n = 0
    cnt = 0
    for rec in records:
        keep, score, intron_n = gtf_filter(rec, params, rm)
        if not keep:
            continue
        if rec.qname == lqname:
            if score > b_score:
                best = rec
                s_score = b_score
                b_score = score
                b_intron_n = intron_n
            elif score > s_score:
                s_score = score
        else:
            if (lqname is not None and s_score < params.sec_rat * b_score and
                    b_intron_n >= params.min_intron_n):
                yield best
                cnt += 1
            best = rec
            b_score = score
            s_score = 0
            b_intron_n = intron_n
            lqname = rec.qname
    if (lqname is not None and s_score < params.sec_rat * b_score and
            b_intron_n >= params.min_intron_n):
        yield best
        cnt += 1
    log("bam_filter", "Filtered alignments: %d", cnt)
