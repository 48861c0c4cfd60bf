"""Transcript classification: known / novel / unrecognized.

Faithful reimplementation of the update-gtf classification core
(reference update_gtf.c):

  check_iden            <- gtf.c:54-92
  exon_overlap_frac     <- update_gtf.c:80-89
  check_full/set_full   <- update_gtf.c:629-696
  check_splice_site     <- update_gtf.c:717-779
  check_with_anno_trans <- update_gtf.c:792-835
  check_short_sj*       <- update_gtf.c:589-709
  split_trans           <- update_gtf.c:837-913
  check_trans           <- update_gtf.c:936-965

All per-transcript inner loops are vectorized with numpy over the padded
exon tensors; the outer sweep keeps the reference's merge-join cursor over
coordinate-sorted transcript lists (the cursor makes the sweep O(n + m)
overall, so transcript counts in the hundreds of thousands stay cheap).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..io.sj import SJTable
from .model import Transcripts, UpdateGtfParams
from .merge import merge_trans


def exon_overlap_frac(s1: int, e1: int, s2: int, e2: int) -> float:
    """overlap_len / min(len1, len2) (reference update_gtf.c:80-89)."""
    if s1 > e2 or s2 > e1:
        return 0.0
    overlap = min(e1, e2) - max(s1, s2) + 1
    min_len = min(e1 - s1 + 1, e2 - s2 + 1)
    return overlap / min_len


def check_iden(t1: Transcripts, i1: int, t2: Transcripts, i2: int,
               ss_dis: int, end_dis: int) -> int:
    """Identity/containment check on splice chains.

    Returns (reference check_iden, gtf.c:54-92):
      0  - equal exon counts, identical splice chains (within ss_dis; ends
           within end_dis)
      2  - different exon counts and the shorter chain's junctions embed
           consecutively in the longer one ("contained")
      -1 - neither

    Faithful quirk: the reference's `partial_match = 1` initialization is
    dead — on any successful containment anchor it is overwritten with 2
    (gtf.c:81), so a return of 1 ("t1 fully contains t2", consumed by
    merge_trans1's modify branch at update_gtf.c:114) can never happen.

    Dispatches to the native kernel when available (bit-equal; tested).
    """
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        it = int(t1.exon_start.itemsize)
        w1 = int(t1.exon_start.shape[1])
        w2 = int(t2.exon_start.shape[1])
        return lib.check_iden_c(
            t1.exon_start.ctypes.data + i1 * w1 * it,
            t1.exon_end.ctypes.data + i1 * w1 * it, int(t1.exon_n[i1]),
            t2.exon_start.ctypes.data + i2 * w2 * it,
            t2.exon_end.ctypes.data + i2 * w2 * it, int(t2.exon_n[i2]),
            ss_dis, end_dis)
    return check_iden_np(t1, i1, t2, i2, ss_dis, end_dis)


def check_iden_np(t1: Transcripts, i1: int, t2: Transcripts, i2: int,
                  ss_dis: int, end_dis: int) -> int:
    """Numpy reference implementation (see check_iden)."""
    n1, n2 = int(t1.exon_n[i1]), int(t2.exon_n[i2])
    s1, e1 = t1.exons(i1)
    s2, e2 = t2.exons(i2)
    if n1 == n2:
        if abs(int(s1[0]) - int(s2[0])) > end_dis:
            return -1
        if n1 > 1:
            if np.any(np.abs(e1[:-1].astype(np.int64) - e2[:-1]) > ss_dis):
                return -1
            if np.any(np.abs(s1[1:].astype(np.int64) - s2[1:]) > ss_dis):
                return -1
        if abs(int(e1[-1]) - int(e2[-1])) > end_dis:
            return -1
        return 0
    # containment path: l = longer, s = shorter
    if n1 > n2:
        ls, le, ln = s1, e1, n1
        ss, se, sn = s2, e2, n2
    else:
        ls, le, ln = s2, e2, n2
        ss, se, sn = s1, e1, n1
    if sn < 2:
        # reference precondition (merge_trans guards multi-exon); explicit
        # no-match instead of the reference's out-of-bounds read
        return -1
    if abs(int(ls[0]) - int(ss[0])) > end_dis:
        return -1
    result = -1
    # find anchor: l's junction i matching s's first junction, then s's
    # remaining junctions must match l's consecutive ones (until either
    # junction list runs out — reference loop condition gtf.c:82)
    for i in range(ln - 1):
        if (abs(int(le[i]) - int(se[0])) <= ss_dis and
                abs(int(ls[i + 1]) - int(ss[1])) <= ss_dis):
            m = min(ln - 2 - i, sn - 2)
            if m > 0:
                li = np.arange(i + 1, i + 1 + m)
                si = np.arange(1, 1 + m)
                if np.any(np.abs(le[li].astype(np.int64) - se[si]) > ss_dis):
                    return -1
                if np.any(np.abs(ls[li + 1].astype(np.int64) - ss[si + 1]) > ss_dis):
                    return -1
            result = 2
            break
    if abs(int(le[-1]) - int(se[-1])) > end_dis:
        return -1
    return result


def exon_overlap(s1: int, e1: int, s2: int, e2: int) -> bool:
    return not (s1 > e2 or s2 > e1)


def check_full(bam_T: Transcripts, bi: int, anno_T: Transcripts, ai: int,
               level: int) -> None:
    """Accumulate lfull/rfull/lnoth/rnoth flags (reference update_gtf.c:629-681).

    NOTE (faithful quirk): left/right here are in *coordinate* order, and
    exon[0]-vs-exon[0] comparisons at level 1/2 use the raw exon arrays, so
    for '-'-strand annotation the biological 5'/3' are swapped — exactly as
    in the reference.
    """
    fl = bam_T.flags
    if fl["lfull"][bi] and fl["rfull"][bi]:
        return
    bs, be = bam_T.exons(bi)
    as_, ae = anno_T.exons(ai)
    i, j = len(bs) - 1, len(as_) - 1
    if level == 1:  # identical first and last splice-site
        if not fl["lfull"][bi] and int(be[0]) == int(ae[0]):
            fl["lfull"][bi] = True
        if not fl["rfull"][bi] and int(bs[i]) == int(as_[j]):
            fl["rfull"][bi] = True
    elif level == 2:  # overlapping first and last exon
        if not fl["lfull"][bi] and exon_overlap(bs[0], be[0], as_[0], ae[0]):
            fl["lfull"][bi] = True
        if not fl["rfull"][bi] and exon_overlap(bs[i], be[i], as_[j], ae[j]):
            fl["rfull"][bi] = True
    elif level == 3:  # overlap first/last exon, or overlap nothing
        if not fl["lfull"][bi]:
            if exon_overlap(bs[0], be[0], as_[0], ae[0]):
                fl["lfull"][bi] = True
            elif np.any((bs[0] <= ae) & (as_ <= be[0])):
                fl["lnoth"][bi] = False
        if not fl["rfull"][bi]:
            if exon_overlap(bs[i], be[i], as_[j], ae[j]):
                fl["rfull"][bi] = True
            elif np.any((bs[i] <= ae) & (as_ <= be[i])):
                fl["rnoth"][bi] = False
    elif level == 4:  # 5' exon per level-3 rule only
        if not fl["lfull"][bi]:
            if exon_overlap(bs[0], be[0], as_[0], ae[0]):
                fl["lfull"][bi] = True
            elif np.any((bs[0] <= ae) & (as_ <= be[0])):
                fl["lnoth"][bi] = False


def set_full(bam_T: Transcripts, bi: int, level: int) -> None:
    """Finalize the `full` bit (reference set_full, update_gtf.c:683-696)."""
    fl = bam_T.flags
    if level == 5:
        fl["full"][bi] = True
    elif level == 4:
        fl["full"][bi] = bool(fl["lfull"][bi] or fl["lnoth"][bi])
    elif level == 3:
        fl["full"][bi] = bool((fl["lfull"][bi] or fl["lnoth"][bi]) and
                              (fl["rfull"][bi] or fl["rnoth"][bi]))
    else:
        fl["full"][bi] = bool(fl["lfull"][bi] and fl["rfull"][bi])


def check_splice_site(bam_T: Transcripts, bi: int, anno_T: Transcripts, ai: int,
                      dis: int, ref_compat: bool = False) -> int:
    """Match bam transcript splice sites vs one annotation transcript.

    Returns 0 (no known site), 1 (known), 2 (has known site); clears
    novel_site/exon/junction flags on matches (reference update_gtf.c:717-779).

    Faithful quirk: "known" (return 1) means every splice *site* of the bam
    transcript is annotated and inside the overlap — the exon *chain* is
    never compared, so an exon-skipping isoform whose remaining sites are
    all annotated classifies as known, exactly as in the reference.

    DOCUMENTED DEVIATION (default, ref_compat=False): annotation acceptors
    are matched against the bam transcript's true acceptor sites bs[1:].
    The reference's loop (update_gtf.c:744-750) instead compares
    exon[j].start for j in 0..bn-2 — the transcript start plus every
    acceptor EXCEPT the last — and clears flag 2j+1 for the j it matched.
    Under that semantics a perfect multi-exon match always scores
    identical_site_n = 2n-3 < 2n-2, so no multi-exon transcript can ever
    classify "known".  ref_compat=True replicates the reference
    bit-for-bit; both modes are fuzz-verified against the compiled
    reference C in tests/test_reference_oracle.py.  See ARCHITECTURE.md §5.

    Dispatches to the native kernel when available (bit-equal; tested).
    """
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        bn = int(bam_T.exon_n[bi])
        an = int(anno_T.exon_n[ai])
        # raw-pointer call: row views of C-order 2D arrays are contiguous
        it = int(bam_T.exon_start.itemsize)
        bw = int(bam_T.exon_start.shape[1])
        aw = int(anno_T.exon_start.shape[1])
        ret = lib.check_splice_site_c(
            bam_T.exon_start.ctypes.data + bi * bw * it,
            bam_T.exon_end.ctypes.data + bi * bw * it, bn,
            anno_T.exon_start.ctypes.data + ai * aw * it,
            anno_T.exon_end.ctypes.data + ai * aw * it, an,
            int(bam_T.start[bi]), int(bam_T.end[bi]),
            int(anno_T.start[ai]), int(anno_T.end[ai]), dis,
            bam_T.novel_site_flag.ctypes.data +
            bi * bam_T.novel_site_flag.shape[1],
            bam_T.novel_exon_flag.ctypes.data +
            bi * bam_T.novel_exon_flag.shape[1],
            bam_T.novel_junction_flag.ctypes.data +
            bi * bam_T.novel_junction_flag.shape[1],
            int(ref_compat))
        if ret == 1:
            bam_T.flags["known"][bi] = True
        elif ret == 2:
            bam_T.flags["has_known_site"][bi] = True
        return ret
    return check_splice_site_np(bam_T, bi, anno_T, ai, dis, ref_compat)


def check_splice_site_np(bam_T: Transcripts, bi: int, anno_T: Transcripts,
                         ai: int, dis: int, ref_compat: bool = False) -> int:
    """Numpy reference implementation (see check_splice_site)."""
    bs, be = bam_T.exons(bi)
    as_, ae = anno_T.exons(ai)
    bn, an = len(bs), len(as_)
    ovlp_start = max(int(bam_T.start[bi]), int(anno_T.start[ai]))
    ovlp_end = min(int(bam_T.end[bi]), int(anno_T.end[ai]))

    bam_don = be[:-1].astype(np.int64)       # bam donor sites
    # acceptor candidates: true acceptors bs[1:] by default; the
    # reference's off-by-one window bs[:-1] in ref_compat mode (matched j
    # still clears flag 2j+1 — see check_splice_site docstring)
    bam_acc = bs[:-1].astype(np.int64) if ref_compat else bs[1:].astype(np.int64)
    bam_acc_ovlp = bs[1:].astype(np.int64)   # ovlp count always uses true sites
    anno_don = ae[:-1].astype(np.int64)
    anno_acc = as_[1:].astype(np.int64)

    in_ov = lambda x: (x >= ovlp_start) & (x <= ovlp_end)
    bam_ovlp_site_n = int(np.sum(in_ov(bam_don))) + int(np.sum(in_ov(bam_acc_ovlp)))
    anno_don_ov = in_ov(anno_don)
    anno_acc_ov = in_ov(anno_acc)

    # identical_site_n counts every (overlapping-anno-site, bam-site) pair
    # within dis — including duplicate matches, exactly like the C loops.
    don_match = np.abs(anno_don[:, None] - bam_don[None, :]) <= dis  # [an-1, bn-1]
    acc_match = np.abs(anno_acc[:, None] - bam_acc[None, :]) <= dis
    # the junction loop (update_gtf.c:761-768) uses true acceptors even in
    # the reference, so it is compat-invariant
    acc_match_true = (np.abs(anno_acc[:, None] - bam_acc_ovlp[None, :]) <= dis
                      if ref_compat else acc_match)
    identical_site_n = int(np.sum(don_match[anno_don_ov])) + \
        int(np.sum(acc_match[anno_acc_ov]))
    # clear novel-site flags (don at 2j, acc at 2j+1)
    if bn > 1 and an > 1:
        don_hit = np.any(don_match[anno_don_ov], axis=0)
        acc_hit = np.any(acc_match[anno_acc_ov], axis=0)
        idx = np.nonzero(don_hit)[0]
        bam_T.novel_site_flag[bi, idx * 2] = 0
        idx = np.nonzero(acc_hit)[0]
        bam_T.novel_site_flag[bi, idx * 2 + 1] = 0

    # novel-exon clearing: any anno exon within dis on both ends
    ex_match = (np.abs(as_.astype(np.int64)[:, None] - bs[None, :]) <= dis) & \
               (np.abs(ae.astype(np.int64)[:, None] - be[None, :]) <= dis)
    bam_T.novel_exon_flag[bi, : bn][np.any(ex_match, axis=0)] = 0

    # novel-junction clearing
    if bn > 1 and an > 1:
        jn_match = don_match & acc_match_true
        bam_T.novel_junction_flag[bi, : bn - 1][np.any(jn_match, axis=0)] = 0

    bam_all_site_n = (bn - 1) * 2
    if bam_all_site_n == bam_ovlp_site_n and bam_ovlp_site_n == identical_site_n:
        bam_T.flags["known"][bi] = True
        return 1
    if identical_site_n > 0:
        bam_T.flags["has_known_site"][bi] = True
        return 2
    return 0


def comp_trans(t1: Transcripts, i1: int, t2: Transcripts, i2: int) -> int:
    """-1: t1 wholly before t2; 1: after; 0: overlap (reference
    update_gtf.c:786-790)."""
    if (t1.tid[i1] < t2.tid[i2] or
            (t1.tid[i1] == t2.tid[i2] and t1.end[i1] <= t2.start[i2])):
        return -1
    if (t2.tid[i2] < t1.tid[i1] or
            (t2.tid[i2] == t1.tid[i1] and t2.end[i2] <= t1.start[i1])):
        return 1
    return 0


def check_with_anno_trans(bam_T: Transcripts, bi: int, anno_T: Transcripts,
                          last_anno_i: int, ugp: UpdateGtfParams) -> int:
    """Classify one bam transcript against the annotation sweep
    (reference update_gtf.c:792-835).  Returns the updated cursor."""
    single_exon = int(bam_T.exon_n[bi]) == 1
    ref_anno_i = -1
    i = last_anno_i
    while i < anno_T.n:
        ret = comp_trans(bam_T, bi, anno_T, i)
        if ret < 0:
            break
        if ret > 0:
            if last_anno_i == i:
                last_anno_i += 1
        else:
            check_full(bam_T, bi, anno_T, i, ugp.full_level)
            an = int(anno_T.exon_n[i])
            if single_exon and an == 1:
                bs, be = bam_T.exons(bi)
                as_, ae = anno_T.exons(i)
                if exon_overlap_frac(int(bs[0]), int(be[0]), int(as_[0]),
                                     int(ae[0])) >= ugp.single_exon_ovlp_frac:
                    ref_anno_i = i
                    bam_T.flags["known"][bi] = True
                    break
            elif not single_exon and an > 1:
                ret = check_splice_site(bam_T, bi, anno_T, i, ugp.ss_dis,
                                        ugp.ref_acceptor_compat)
                if ret == 1:
                    ref_anno_i = i
                    break
                if ret == 2:
                    ref_anno_i = i
        i += 1

    if ref_anno_i != -1:
        anno_is_rev = bool(anno_T.is_rev[ref_anno_i])
        bam_T.is_rev[bi] = 1 if anno_is_rev else 0
        bam_T.gene_id[bi] = anno_T.gene_id[ref_anno_i]
        bam_T.gene_name[bi] = anno_T.gene_name[ref_anno_i]
    else:
        bam_T.gene_id[bi] = "NA"
        bam_T.gene_name[bi] = "NA"
    set_full(bam_T, bi, ugp.full_level)
    return last_anno_i


def _check_short_sj1(tid: int, start: int, end: int, sj: SJTable,
                     i_start: int, ugp: UpdateGtfParams) -> bool:
    """Is junction (start..end intron coords) supported by the SJ table?
    (reference check_short_sj1, update_gtf.c:589-603)."""
    dis, min_cnt = ugp.ss_dis, ugp.min_sj_cnt
    i = i_start
    while i < sj.n:
        if sj.tid[i] > tid or (sj.tid[i] == tid and sj.don[i] >= end):
            return False
        if abs(int(sj.don[i]) - start) <= dis and abs(int(sj.acc[i]) - end) <= dis:
            cnt = int(sj.uniq_c[i]) + (int(sj.multi_c[i]) if ugp.use_multi else 0)
            if cnt >= min_cnt:
                return True
        i += 1
    return False


def check_with_short_sj(bam_T: Transcripts, bi: int, sj: SJTable,
                        last_sj_i: int, ugp: UpdateGtfParams) -> Tuple[bool, int]:
    """Validate all already-novel junctions of bam_t against short-read SJ
    counts (reference check_with_short_sj + check_short_sj,
    update_gtf.c:609-709).  Returns (supported, new cursor)."""
    en = int(bam_T.exon_n[bi])
    sj_map = 1 - bam_T.novel_junction_flag[bi, : en - 1]
    bs, be = bam_T.exons(bi)
    ret = True
    found_window = False
    i = last_sj_i
    while i < sj.n:
        if (sj.tid[i] < bam_T.tid[bi] or
                (sj.tid[i] == bam_T.tid[bi] and sj.acc[i] <= bam_T.start[bi])):
            i += 1
            last_sj_i = i
        elif (sj.tid[i] > bam_T.tid[bi] or
                (sj.tid[i] == bam_T.tid[bi] and sj.don[i] >= bam_T.end[bi])):
            ret = False
            found_window = True  # reference returns 0 outright here
            break
        else:
            for j in range(en - 1):
                if sj_map[j] == 0 and not _check_short_sj1(
                        int(bam_T.tid[bi]), int(be[j]) + 1, int(bs[j + 1]) - 1,
                        sj, i, ugp):
                    bam_T.unreliable_junction_flag[bi, j] = 1
                    ret = False
            found_window = True
            break
    if not found_window:
        ret = False  # ran off the table (reference returns 0)
    bam_T.flags["has_unreliable_junction"][bi] = not ret
    return ret, last_sj_i


def sj_check_batch(bam_T: Transcripts, idx: np.ndarray, sj: SJTable,
                   ugp: UpdateGtfParams) -> Optional[np.ndarray]:
    """Batched check_with_short_sj over reads idx (ascending coordinate
    order, shared SJ cursor — reference check_trans update_gtf.c:947).
    Mutates unreliable_junction_flag / has_unreliable_junction in place
    like the scalar path; returns supported[len(idx)] bool, or None when
    the native lib is unavailable.  Agreement with the scalar path is
    pinned by tests/test_classify_fixtures.py (both paths) and the
    randomized sweep in tests/test_classify_batch.py."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, np.int64)
    supported = np.zeros(len(idx), np.uint8)
    if not len(idx):
        return supported.astype(bool)
    lib.sj_check_batch_c(
        bam_T.exon_start.ctypes.data, bam_T.exon_end.ctypes.data,
        bam_T.exon_start.shape[1],
        bam_T.exon_n.ctypes.data, bam_T.tid.ctypes.data,
        bam_T.start.ctypes.data, bam_T.end.ctypes.data,
        bam_T.novel_junction_flag.ctypes.data,
        bam_T.novel_junction_flag.shape[1],
        bam_T.unreliable_junction_flag.ctypes.data,
        bam_T.unreliable_junction_flag.shape[1],
        bam_T.flags["has_unreliable_junction"].ctypes.data,
        idx.ctypes.data, len(idx),
        np.ascontiguousarray(sj.tid, np.int32).ctypes.data,
        np.ascontiguousarray(sj.don, np.int32).ctypes.data,
        np.ascontiguousarray(sj.acc, np.int32).ctypes.data,
        np.ascontiguousarray(sj.uniq_c, np.int32).ctypes.data,
        np.ascontiguousarray(sj.multi_c, np.int32).ctypes.data, sj.n,
        ugp.ss_dis, ugp.min_sj_cnt, int(ugp.use_multi),
        supported.ctypes.data)
    return supported.astype(bool)


def _split_ranges(bam_T: Transcripts, bi: int) -> list:
    """Fragment (lo, hi) exon ranges for split_trans — native kernel when
    available, python otherwise (identical semantics; reference
    update_gtf.c:837-913 loop structure)."""
    en = int(bam_T.exon_n[bi])
    from ..native import get_lib
    lib = get_lib()
    if lib is not None:
        idx = np.array([bi], np.int64)
        stride = max(en, 1)
        lo = np.zeros(stride, np.int32)
        hi = np.zeros(stride, np.int32)
        nf = np.zeros(1, np.int32)
        lib.split_trans_batch_c(
            bam_T.exon_n.ctypes.data,
            bam_T.novel_junction_flag.ctypes.data,
            bam_T.novel_junction_flag.shape[1],
            bam_T.unreliable_junction_flag.ctypes.data,
            bam_T.unreliable_junction_flag.shape[1],
            idx.ctypes.data, 1,
            lo.ctypes.data, hi.ctypes.data, stride, nf.ctypes.data)
        return [(int(lo[t]), int(hi[t])) for t in range(int(nf[0]))]
    nj = bam_T.novel_junction_flag[bi, : en - 1]
    urj = bam_T.unreliable_junction_flag[bi, : en - 1]
    out = []
    last = 0
    has_novel = has_known = False
    for i in range(en - 1):
        if nj[i]:
            has_novel = True
        else:
            has_known = True
        if urj[i]:
            if has_novel and has_known and i - last >= 1:
                out.append((last, i))
            last = i + 1
            has_novel = has_known = False
    if has_novel and has_known and (en - 1) - last >= 1:
        out.append((last, en - 1))
    return out


def split_trans(bam_T: Transcripts, bi: int) -> Transcripts:
    """Cut a read at unreliable junctions, keeping multi-exon fragments that
    contain >=1 known and >=1 novel junction (reference update_gtf.c:837-913)."""
    out = Transcripts()
    en = int(bam_T.exon_n[bi])
    bs, be = bam_T.exons(bi)
    nj = bam_T.novel_junction_flag[bi, : en - 1]
    ns = bam_T.novel_site_flag[bi, : 2 * (en - 1)]
    ne = bam_T.novel_exon_flag[bi, : en]

    trans_i = 0

    def _emit(lo: int, hi: int) -> None:
        """copy exons [lo, hi] as a split fragment."""
        nonlocal trans_i
        n = hi - lo + 1
        site = np.ones(2 * (n - 1), np.uint8)
        for j in range(lo, hi):
            site[(j - lo) * 2] = ns[j * 2]
            site[(j - lo) * 2 + 1] = ns[j * 2 + 1]
        out.append(
            int(bam_T.tid[bi]), bool(bam_T.is_rev[bi]),
            bs[lo: hi + 1].copy(), be[lo: hi + 1].copy(),
            gene_id=bam_T.gene_id[bi], gene_name=bam_T.gene_name[bi],
            trans_id=f"{bam_T.trans_id[bi]}.split.{trans_i}",
            trans_name=f"{bam_T.trans_name[bi]}.split.{trans_i}",
            cov=1, init_novel=False,
            flags=dict(full=False, lfull=False, lnoth=True, rfull=False,
                       rnoth=True, known=False, has_known_site=False,
                       has_unreliable_junction=False, partial_read=True),
            novel_exon_flag=ne[lo: hi + 1].copy(),
            novel_site_flag=site,
            novel_junction_flag=nj[lo: hi].copy(),
            unreliable_junction_flag=np.zeros(n - 1, np.uint8),
        )
        trans_i += 1

    for lo, hi in _split_ranges(bam_T, bi):
        _emit(lo, hi)
    return out


def split_trans_many(bam_T: Transcripts, idx: np.ndarray
                     ) -> Tuple[Transcripts, np.ndarray]:
    """Vectorized split_trans over many reads (semantics identical to the
    per-read path; reference update_gtf.c:837-913).  Returns (frag_T,
    frag_of): fragments grouped by read in read order, frag_of[k] = the
    position in `idx` of fragment k's source read.  Fragment naming
    matches split_trans (`<id>.split.<t>`, t per-read ordinal)."""
    from ..native import get_lib
    lib = get_lib()
    idx = np.ascontiguousarray(idx, np.int64)
    m = len(idx)
    out = Transcripts()
    if m == 0:
        return out, np.zeros(0, np.int64)
    stride = max(int(bam_T.exon_n[idx].max()), 1)
    lo = np.zeros(m * stride, np.int32)
    hi = np.zeros(m * stride, np.int32)
    nf = np.zeros(m, np.int32)
    if lib is not None:
        lib.split_trans_batch_c(
            bam_T.exon_n.ctypes.data,
            bam_T.novel_junction_flag.ctypes.data,
            bam_T.novel_junction_flag.shape[1],
            bam_T.unreliable_junction_flag.ctypes.data,
            bam_T.unreliable_junction_flag.shape[1],
            idx.ctypes.data, m,
            lo.ctypes.data, hi.ctypes.data, stride, nf.ctypes.data)
    else:
        for t, bi in enumerate(idx.tolist()):
            for k, (l, h) in enumerate(_split_ranges(bam_T, int(bi))):
                lo[t * stride + k] = l
                hi[t * stride + k] = h
                nf[t] += 1
    total = int(nf.sum())
    frag_of = np.repeat(np.arange(m, dtype=np.int64), nf)
    if total == 0:
        return out, frag_of
    # flatten the per-read (lo, hi) slots into fragment rows
    slot = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(nf)[:-1]]).astype(np.int64), nf)
    flat = frag_of * stride + slot
    flo = lo[flat].astype(np.int64)
    fhi = hi[flat].astype(np.int64)
    fbi = idx[frag_of]
    lens = fhi - flo + 1
    E = int(lens.max())
    cols = np.arange(E, dtype=np.int64)
    src = np.minimum(flo[:, None] + cols[None, :],
                     fhi[:, None])                       # clamp to hi
    valid = cols[None, :] < lens[:, None]
    es = np.where(valid, bam_T.exon_start[fbi[:, None], src], 0)
    ee = np.where(valid, bam_T.exon_end[fbi[:, None], src], 0)
    out._grow_rows(total)
    out._grow_exons(E)
    sl = slice(0, total)
    out.exon_start[sl, :E] = es
    out.exon_end[sl, :E] = ee
    out.exon_n[sl] = lens
    out.tid[sl] = bam_T.tid[fbi]
    out.is_rev[sl] = bam_T.is_rev[fbi]
    out.start[sl] = es[:, 0]
    out.end[sl] = ee[np.arange(total), lens - 1]
    out.cov[sl] = 1
    # flags: full=0, lnoth/rnoth=1, partial_read=1 (update_gtf.c:855-856)
    out.flags["lnoth"][sl] = True
    out.flags["rnoth"][sl] = True
    out.flags["partial_read"][sl] = True
    # novelty slices: exon flags [lo, hi], site/junction flags [lo, hi)
    out.novel_exon_flag[sl, :E] = np.where(
        valid, bam_T.novel_exon_flag[fbi[:, None], src], 0)
    jcols = np.arange(max(E - 1, 1), dtype=np.int64)
    jvalid = jcols[None, :] < (lens - 1)[:, None]
    jsrc = np.minimum(flo[:, None] + jcols[None, :],
                      np.maximum(fhi - 1, flo)[:, None])
    out.novel_junction_flag[sl, : max(E - 1, 1)] = np.where(
        jvalid, bam_T.novel_junction_flag[fbi[:, None], jsrc], 0)
    out.unreliable_junction_flag[sl, : max(E - 1, 1)] = 0
    ns = np.where(jvalid, bam_T.novel_site_flag[fbi[:, None], jsrc * 2], 0)
    na = np.where(jvalid,
                  bam_T.novel_site_flag[fbi[:, None], jsrc * 2 + 1], 0)
    site = np.empty((total, 2 * max(E - 1, 1)), np.uint8)
    site[:, 0::2] = ns
    site[:, 1::2] = na
    out.novel_site_flag[sl, : 2 * max(E - 1, 1)] = site
    # names: per-read fragment ordinal
    for k in range(total):
        bi = int(fbi[k])
        t = int(slot[k])
        out.gene_id.append(bam_T.gene_id[bi])
        out.gene_name.append(bam_T.gene_name[bi])
        out.trans_id.append(f"{bam_T.trans_id[bi]}.split.{t}")
        out.trans_name.append(f"{bam_T.trans_name[bi]}.split.{t}")
    out.n = total
    return out, frag_of


def classify_batch_native(bam_T: Transcripts, anno_T: Transcripts,
                          ugp: UpdateGtfParams):
    """Run the whole check_with_anno_trans sweep in one native call
    (csrc classify_batch_c; ~70x the python per-read loop at 500k reads).
    Fills bam_T flags + novel-flag clearing and adopts gene ids/strand.
    Returns None when the native lib is unavailable."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None or bam_T.n == 0:
        return None
    it = bam_T.exon_start.itemsize
    ref_anno = np.empty(bam_T.n, np.int64)
    for a in (bam_T.exon_start, bam_T.exon_end, anno_T.exon_start,
              anno_T.exon_end):
        assert a.flags["C_CONTIGUOUS"]
    lib.classify_batch_c(
        bam_T.exon_start.ctypes.data, bam_T.exon_end.ctypes.data,
        bam_T.exon_start.shape[1],
        bam_T.exon_n.ctypes.data, bam_T.tid.ctypes.data,
        bam_T.start.ctypes.data, bam_T.end.ctypes.data, bam_T.n,
        bam_T.flags["known"].ctypes.data,
        bam_T.flags["has_known_site"].ctypes.data,
        bam_T.flags["full"].ctypes.data,
        bam_T.flags["lfull"].ctypes.data, bam_T.flags["rfull"].ctypes.data,
        bam_T.flags["lnoth"].ctypes.data, bam_T.flags["rnoth"].ctypes.data,
        bam_T.novel_site_flag.ctypes.data, bam_T.novel_site_flag.shape[1],
        bam_T.novel_exon_flag.ctypes.data, bam_T.novel_exon_flag.shape[1],
        bam_T.novel_junction_flag.ctypes.data,
        bam_T.novel_junction_flag.shape[1],
        anno_T.exon_start.ctypes.data, anno_T.exon_end.ctypes.data,
        anno_T.exon_start.shape[1],
        anno_T.exon_n.ctypes.data, anno_T.tid.ctypes.data,
        anno_T.start.ctypes.data, anno_T.end.ctypes.data, anno_T.n,
        ugp.full_level, ugp.ss_dis, ugp.single_exon_ovlp_frac,
        int(ugp.ref_acceptor_compat),
        ref_anno.ctypes.data)
    # gene/strand adoption (strings stay host-side)
    has = ref_anno >= 0
    ra = np.where(has, ref_anno, 0)
    bam_T.is_rev[:bam_T.n] = np.where(has, anno_T.is_rev[ra],
                                      bam_T.is_rev[:bam_T.n])
    gid, gname = bam_T.gene_id, bam_T.gene_name
    agid, agname = anno_T.gene_id, anno_T.gene_name
    for bi in range(bam_T.n):
        r = ref_anno[bi]
        if r >= 0:
            gid[bi] = agid[r]
            gname[bi] = agname[r]
        else:
            gid[bi] = "NA"
            gname[bi] = "NA"
    return ref_anno


def check_trans(bam_T: Transcripts, anno_T: Transcripts, sj: SJTable,
                ugp: UpdateGtfParams,
                updated_T: Transcripts, known_T: Transcripts,
                novel_T: Transcripts, unrecog_T: Transcripts) -> None:
    """The classification driver (reference check_trans, update_gtf.c:936-965).

    bam_T and anno_T must be coordinate-sorted.  Mutates bam_T's flags in
    place and appends into the four output sets.
    """
    swept = classify_batch_native(bam_T, anno_T, ugp) is not None
    if swept:
        fl = bam_T.flags
        n = bam_T.n
        full = fl["full"][:n]
        known = fl["known"][:n] & full
        has_site = fl["has_known_site"][:n] & full & ~fl["known"][:n]
        unrec = full & ~fl["known"][:n] & ~fl["has_known_site"][:n]
        known_T.append_many(bam_T, np.nonzero(known)[0])
        unrecog_T.append_many(bam_T, np.nonzero(unrec)[0])
        # novel path: SJ-validate per read, then merge candidates into
        # updated_T through the batched native scan, grouped into
        # contiguous same-source runs so ordering semantics are untouched
        from .merge import merge_candidates_batch
        last_sj_i = 0
        run_idx: list = []

        def _flush(src):
            if not run_idx:
                return
            idxa = np.asarray(run_idx, np.int64)
            run_idx.clear()
            novel_T.append_many(src, idxa)
            m = merge_candidates_batch(src, idxa, updated_T,
                                       ugp.force_strand, ugp.ss_dis,
                                       ugp.end_dis,
                                       ugp.single_exon_ovlp_frac)
            if m is None:
                for i in idxa.tolist():
                    if not merge_trans(src, i, updated_T, ugp.force_strand,
                                       ugp.ss_dis, ugp.end_dis,
                                       ugp.single_exon_ovlp_frac):
                        updated_T.append_from(src, i)

        has_idx = np.nonzero(has_site)[0]
        if sj.n == 0:
            supported = np.ones(len(has_idx), bool)
        else:
            # batched native sweep (sj_check_batch_c) — pass 2's last
            # per-read python loop collapses to one call
            supported = sj_check_batch(bam_T, has_idx, sj, ugp)
            if supported is None:          # lib vanished mid-run: scalar
                supported = np.zeros(len(has_idx), bool)
                for t, bi in enumerate(has_idx.tolist()):
                    supported[t], last_sj_i = check_with_short_sj(
                        bam_T, bi, sj, last_sj_i, ugp)
        if not ugp.split_trans:
            run_idx.extend(has_idx[supported].tolist())
            _flush(bam_T)
            return
        # -s: unsupported reads split in place; novel_T / updated_T keep
        # exact read order (fragments interleave at their read position).
        # All fragments materialize in ONE vectorized pass and the whole
        # interleaved candidate sequence goes through ONE append + ONE
        # sequential native merge — the per-read flush loop cost ~60 us
        # per read at 100k novels/sample (see tests/test_classify_batch.py
        # ordering pins)
        from ..native import get_lib
        if get_lib() is None:
            for t, bi in enumerate(has_idx.tolist()):
                if supported[t]:
                    run_idx.append(bi)
                    continue
                _flush(bam_T)
                split_T = split_trans(bam_T, bi)
                if split_T.n:
                    run_idx.extend(range(split_T.n))
                    _flush(split_T)
            _flush(bam_T)
            return
        unsup_pos = np.nonzero(~supported)[0]
        frag_T, frag_of = split_trans_many(bam_T, has_idx[unsup_pos])
        n_sup = int(np.count_nonzero(supported))
        scratch = Transcripts()
        scratch.append_many(bam_T, has_idx[supported])     # S rows [0, n_sup)
        scratch.append_many(frag_T, np.arange(frag_T.n))
        # interleaved order over has_idx: 1 slot per supported read,
        # nf slots per unsupported read
        counts = supported.astype(np.int64).copy()
        nf = np.bincount(frag_of, minlength=len(unsup_pos)).astype(np.int64)
        counts[unsup_pos] = nf
        starts = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        perm = np.empty(starts[-1], np.int64)
        sup_rank = np.cumsum(supported) - 1
        perm[starts[:-1][supported]] = sup_rank[supported]
        if frag_T.n:
            fstart = np.zeros(len(unsup_pos) + 1, np.int64)
            np.cumsum(nf, out=fstart[1:])
            pos = (np.repeat(starts[:-1][unsup_pos], nf) +
                   np.arange(frag_T.n) - np.repeat(fstart[:-1], nf))
            perm[pos] = n_sup + np.arange(frag_T.n)
        cand = Transcripts()
        cand.append_many(scratch, perm)
        run_idx.extend(range(cand.n))
        _flush(cand)
        return
    last_anno_i = 0
    last_sj_i = 0
    for bi in range(bam_T.n):
        last_anno_i = check_with_anno_trans(bam_T, bi, anno_T, last_anno_i, ugp)
        if not bam_T.flags["full"][bi]:
            continue
        if bam_T.flags["known"][bi]:
            known_T.append_from(bam_T, bi)
        elif bam_T.flags["has_known_site"][bi]:
            if sj.n == 0:
                supported = True
            else:
                supported, last_sj_i = check_with_short_sj(
                    bam_T, bi, sj, last_sj_i, ugp)
            if supported:
                novel_T.append_from(bam_T, bi)
                if not merge_trans(bam_T, bi, updated_T, ugp.force_strand,
                                   ugp.ss_dis, ugp.end_dis,
                                   ugp.single_exon_ovlp_frac):
                    updated_T.append_from(bam_T, bi)
            elif ugp.split_trans:
                split_T = split_trans(bam_T, bi)
                for j in range(split_T.n):
                    novel_T.append_from(split_T, j)
                    if not merge_trans(split_T, j, updated_T, ugp.force_strand,
                                       ugp.ss_dis, ugp.end_dis,
                                       ugp.single_exon_ovlp_frac):
                        updated_T.append_from(split_T, j)
        else:
            unrecog_T.append_from(bam_T, bi)
