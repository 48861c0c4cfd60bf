"""Order-dependent transcript merging/dedup.

merge_trans / merge_trans1 / merge_trans2 (reference update_gtf.c:98-163):
backward scan from the most recently kept transcript; identical multi-exon
chains merge (cov++, end extension); contained chains are absorbed;
single-exon pairs merge on overlap fraction.  The scan stops as soon as the
candidate starts past the kept transcript's end, so with coordinate-sorted
input it is amortized O(1) per call.

uniq_trans (reference unique_gtf.c:73-84) builds the cross-sample unique set.
"""

from __future__ import annotations

from .model import Transcripts


def merge_trans1(t: Transcripts, ti: int, T: Transcripts, Ti: int,
                 ss_dis: int, end_dis: int) -> bool:
    """Merge multi-exon t into kept T (reference update_gtf.c:98-119)."""
    from .classify import check_iden
    ret = check_iden(t, ti, T, Ti, ss_dis, end_dis)
    if ret == 0:  # fully identical: absorb, extend terminal exons
        T.cov[Ti] += 1
        i = int(t.exon_n[ti]) - 1
        j = int(T.exon_n[Ti]) - 1
        if t.exon_start[ti, 0] < T.exon_start[Ti, 0]:
            T.exon_start[Ti, 0] = t.exon_start[ti, 0]
            T.start[Ti] = t.exon_start[ti, 0]
        if t.exon_end[ti, i] > T.exon_end[Ti, j]:
            T.exon_end[Ti, j] = t.exon_end[ti, i]
            T.end[Ti] = t.exon_end[ti, i]
        return True
    if ret == 2:  # containment either way: keep T unchanged
        return True
    # ret == 1 (t fully contains T -> modify_read_trans) is unreachable:
    # see check_iden docstring.
    return False


def merge_trans2(t: Transcripts, ti: int, T: Transcripts, Ti: int,
                 end_dis: int, single_exon_ovlp_frac: float) -> bool:
    """Merge single-exon t into kept T (reference update_gtf.c:122-140)."""
    from .classify import exon_overlap_frac
    ts, te = int(t.exon_start[ti, 0]), int(t.exon_end[ti, 0])
    Ts, Te = int(T.exon_start[Ti, 0]), int(T.exon_end[Ti, 0])
    if abs(ts - Ts) > end_dis or abs(te - Te) > end_dis:
        return False
    if exon_overlap_frac(ts, te, Ts, Te) >= single_exon_ovlp_frac:
        T.cov[Ti] += 1
        if ts < Ts:
            T.exon_start[Ti, 0] = ts
            T.start[Ti] = ts
        if te > Te:
            T.exon_end[Ti, 0] = te
            T.end[Ti] = te
        return True
    return False


def merge_trans(t: Transcripts, ti: int, T: Transcripts, force_strand: bool,
                ss_dis: int, end_dis: int, single_exon_ovlp_frac: float) -> bool:
    """Backward scan merge (reference update_gtf.c:144-163).

    Returns True if t was merged into an existing member of T.
    """
    tn = int(t.exon_n[ti])
    for i in range(T.n - 1, -1, -1):
        if t.tid[ti] > T.tid[i] or t.start[ti] > T.end[i]:
            return False
        if force_strand and t.is_rev[ti] != T.is_rev[i]:
            continue
        Tn = int(T.exon_n[i])
        if tn == 1 and Tn == 1:
            if merge_trans2(t, ti, T, i, end_dis, single_exon_ovlp_frac):
                return True
        elif tn > 1 and Tn > 1:
            if merge_trans1(t, ti, T, i, ss_dis, end_dis):
                return True
    return False


def merge_candidates_batch(cand_T: Transcripts, cand_idx, T: Transcripts,
                           force_strand: bool, ss_dis: int, end_dis: int,
                           single_exon_ovlp_frac: float):
    """Merge a SEQUENCE of candidates into T with one native call
    (csrc merge_into_batch_c; the per-pair python/ctypes crossings cost
    ~20 us each at 500k-read scale).  Returns the merged mask (uint8 per
    candidate), or None when the native lib is unavailable.  Array columns
    of missed candidates are appended in C; strings/flags are backfilled
    here in the same order — results identical to the sequential loop
    (tests/test_merge_batch.py)."""
    import numpy as np

    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    cand_idx = np.ascontiguousarray(cand_idx, np.int64)
    n_cand = len(cand_idx)
    if n_cand == 0:
        return np.zeros(0, np.uint8)
    need_e = int(cand_T.exon_n[cand_idx].max()) if n_cand else 2
    if T.n + n_cand > T._cap:
        T._grow_rows(T.n + n_cand)
    if need_e > T._ecap:
        T._grow_exons(need_e)
    merged = np.zeros(n_cand, np.uint8)
    new_n = int(lib.merge_into_batch_c(
        cand_T.exon_start.ctypes.data, cand_T.exon_end.ctypes.data,
        cand_T.exon_start.shape[1],
        cand_T.exon_n.ctypes.data, cand_T.tid.ctypes.data,
        cand_T.is_rev.ctypes.data, cand_T.start.ctypes.data,
        cand_T.end.ctypes.data, cand_T.cov.ctypes.data,
        cand_idx.ctypes.data, n_cand,
        T.exon_start.ctypes.data, T.exon_end.ctypes.data,
        T.exon_start.shape[1],
        T.exon_n.ctypes.data, T.tid.ctypes.data, T.is_rev.ctypes.data,
        T.start.ctypes.data, T.end.ctypes.data, T.cov.ctypes.data,
        T.n, T._cap,
        int(force_strand), ss_dis, end_dis, single_exon_ovlp_frac,
        merged.ctypes.data))
    assert new_n >= 0, "merge_into_batch_c capacity overflow"
    # backfill non-array columns for the appended rows, in order
    missed = cand_idx[merged == 0]
    rows = T.n + np.arange(len(missed))
    for k, arr in T.flags.items():
        arr[rows] = cand_T.flags[k][missed]
    w = min(T.novel_exon_flag.shape[1], cand_T.novel_exon_flag.shape[1])
    T.novel_exon_flag[rows[:, None], np.arange(w)[None, :]] = \
        cand_T.novel_exon_flag[missed[:, None], np.arange(w)[None, :]]
    w2 = min(T.novel_site_flag.shape[1], cand_T.novel_site_flag.shape[1])
    T.novel_site_flag[rows[:, None], np.arange(w2)[None, :]] = \
        cand_T.novel_site_flag[missed[:, None], np.arange(w2)[None, :]]
    wj = min(T.novel_junction_flag.shape[1],
             cand_T.novel_junction_flag.shape[1])
    T.novel_junction_flag[rows[:, None], np.arange(wj)[None, :]] = \
        cand_T.novel_junction_flag[missed[:, None], np.arange(wj)[None, :]]
    T.unreliable_junction_flag[rows[:, None], np.arange(wj)[None, :]] = \
        cand_T.unreliable_junction_flag[missed[:, None], np.arange(wj)[None, :]]
    for j in missed.tolist():
        T.gene_id.append(cand_T.gene_id[j])
        T.gene_name.append(cand_T.gene_name[j])
        T.trans_id.append(cand_T.trans_id[j])
        T.trans_name.append(cand_T.trans_name[j])
    T.n = int(new_n)
    return merged


def uniq_trans(bam_T: Transcripts, uniq_T: Transcripts, shared_T: Transcripts,
               force_strand: bool, ss_dis: int, end_dis: int,
               single_exon_ovlp_frac: float) -> int:
    """Cross-sample dedup (reference uniq_trans, unique_gtf.c:73-84)."""
    import numpy as np
    merged = merge_candidates_batch(bam_T, np.arange(bam_T.n), uniq_T,
                                    force_strand, ss_dis, end_dis,
                                    single_exon_ovlp_frac)
    if merged is not None:
        shared_T.append_many(bam_T, np.nonzero(merged)[0])
        return uniq_T.n
    for i in range(bam_T.n):
        if merge_trans(bam_T, i, uniq_T, force_strand, ss_dis, end_dis,
                       single_exon_ovlp_frac):
            shared_T.append_from(bam_T, i)
        else:
            uniq_T.append_from(bam_T, i)
    return uniq_T.n
