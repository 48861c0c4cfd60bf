"""Candidate gene-fusion detection (the `fusion` subcommand).

Reference: bam_fusion.c — group alignment segments by qname, sort by
(score desc, edit distance asc), greedily accept segments that overlap
existing picks by <= ovlp_frac in read space and are >= dis apart in ref
space, until read coverage >= all_cov; emit the 2-segment fusions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..io.sam import AlnRec, OP_D, OP_EQ, OP_H, OP_I, OP_M, OP_N, OP_S, OP_X
from ..utils import log

OVLP_FRAC = 0.1     # reference bam_fusion.h:12
EACH_COV = 0.1      # bam_fusion.h:13
ALL_COV = 0.99      # bam_fusion.h:14
FUSION_DIS = 100000  # bam_fusion.h:15


@dataclass
class FusionParams:
    ovlp_frac: float = OVLP_FRAC
    each_cov: float = EACH_COV
    all_cov: float = ALL_COV
    dis: int = FUSION_DIS


@dataclass
class Seg:
    """One alignment segment in read+ref space (reference bam_seg_t,
    parse_bam.h:18-23 / bam2seg parse_bam.c:543-595)."""
    tid: int
    is_rev: bool
    score: int
    ed: int
    read_start: int
    read_end: int
    ref_start: int
    ref_end: int
    rec: AlnRec


def bam2seg(rec: AlnRec) -> Optional[Seg]:
    if rec.is_unmapped:
        return None
    score = int(rec.tags.get("AS", 0))
    ed = int(rec.tags.get("NM", 0))
    rlen = rec.query_len()
    read_start, read_end = 1, 0
    ref_start = rec.pos + 1
    ref_end = ref_start - 1
    for i, c in enumerate(rec.cigar):
        op = int(c) & 0xF
        l = int(c) >> 4
        if op in (OP_M, OP_EQ, OP_X):
            read_end += l
            ref_end += l
        elif op == OP_I:
            read_end += l
        elif op in (OP_D, OP_N):
            ref_end += l
        elif op in (OP_S, OP_H):
            if i == 0:
                read_start += l
                read_end += l
    if rec.is_rev:
        read_start, read_end = rlen + 1 - read_end, rlen + 1 - read_start
    return Seg(rec.tid, rec.is_rev, score, ed, read_start, read_end,
               ref_start, ref_end, rec)


def _ovlp_rat(s1: int, e1: int, s2: int, e2: int) -> float:
    """Faithful reference quirk (bam_fusion.c:67-72): overlap length is
    computed as end1-start2+1 if positive else end2-start1+1 — NOT the true
    intersection — matching ovlp_rat exactly."""
    if s1 > e2 or s2 > e1:
        return 0.0
    overlap = e1 - s2 + 1 if e1 - s2 + 1 > 0 else e2 - s1 + 1
    min_len = min(e1 - s1 + 1, e2 - s2 + 1)
    return overlap / min_len


def _compatible(s1: Seg, s2: Seg, p: FusionParams) -> bool:
    """check_with_exist1 (reference bam_fusion.c:74-87)."""
    if _ovlp_rat(s1.read_start, s1.read_end, s2.read_start, s2.read_end) > p.ovlp_frac:
        return False
    if s1.tid == s2.tid:
        if _ovlp_rat(s1.ref_start, s1.ref_end, s2.ref_start, s2.ref_end) > 0.0:
            return False
        if 0 < s1.ref_start - s2.ref_end < p.dis:
            return False
        if 0 < s2.ref_start - s1.ref_end < p.dis:
            return False
    return True


def _coverage(segs: List[Seg], rlen: int) -> float:
    cov = np.zeros(rlen, bool)
    for s in segs:
        cov[s.read_start - 1: s.read_end] = True
    return cov.sum() / rlen


def check_fusion(segs: List[Seg], rlen: int, p: FusionParams) -> Optional[List[Seg]]:
    """Greedy fusion-segment selection (reference check_fusion,
    bam_fusion.c:114-129).  Returns the selected segments when coverage is
    reached, else None."""
    segs = sorted(segs, key=lambda s: (-s.score, s.ed))
    picked = [segs[0]]
    for s in segs[1:]:
        if (s.read_end - s.read_start + 1) / rlen < p.each_cov:
            continue
        if all(_compatible(q, s, p) for q in picked):
            picked.append(s)
            if _coverage(picked, rlen) >= p.all_cov:
                return picked
    return None


def detect_fusions(records: Iterable[AlnRec], p: FusionParams,
                   fs_fp: Optional[IO[str]] = None,
                   target_names: Optional[List[str]] = None,
                   ) -> Iterator[AlnRec]:
    """Stream records (qname-grouped); yield the records of every 2-segment
    fusion (reference bam_fusion, bam_fusion.c:144-212)."""
    if fs_fp:
        fs_fp.write("#fusion_id\t1st_chr\t1st_strand\tst_start_site\t"
                    "1st_end_site\t2nd_chr\t2nd_strand\t2nd_start_site\t"
                    "2nd_end_site\n")
    cnt = 0
    lqname = None
    segs: List[Seg] = []
    rlen = 0

    def _flush(final=False):
        nonlocal cnt
        if lqname is None or len(segs) < 2:
            return []
        picked = check_fusion(segs, rlen, p)
        if picked is not None and len(picked) == 2:
            cnt += 1
            # faithful quirk: the reference's end-of-stream flush
            # (bam_fusion.c:196-203) writes the SAM records and counts the
            # fusion but never calls fusion_write — the LAST read group's
            # fusion-site line is silently omitted from the -f file
            if not final and fs_fp and target_names:
                a, b = picked
                left, right = (a, b) if a.read_start < b.read_start else (b, a)
                fs_fp.write(
                    f"{left.rec.qname}\t{target_names[left.tid]}\t"
                    f"{'+-'[left.is_rev]}\t{left.ref_start}\t{left.ref_end}\t"
                    f"{target_names[right.tid]}\t{'+-'[right.is_rev]}\t"
                    f"{right.ref_start}\t{right.ref_end}\n")
            return [s.rec for s in picked]
        return []

    for rec in records:
        s = bam2seg(rec)
        if s is None:
            continue
        if rec.qname == lqname:
            segs.append(s)
        else:
            yield from _flush()
            lqname = rec.qname
            rlen = rec.query_len()
            segs = [s]
    yield from _flush(final=True)
    log("bam_fusion", "Candidate gene-fusion transcripts: %d", cnt)
