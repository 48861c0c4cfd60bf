"""update-gtf analytics outputs: summary.txt, detail.txt, novel_exon.bed.

Byte-format ports of print_bam_detail_trans (reference update_gtf.c:297-419)
and print_trans_summary (update_gtf.c:421-587), including the backward-scan
"simp" dedup accumulators (add_simp_gene/exon/site/sj, update_gtf.c:165-295).
"""

from __future__ import annotations

from typing import IO, List, Optional, Tuple

import numpy as np

from ..io.gtf import ChrNames
from ..transcript.merge import merge_trans
from ..transcript.model import Transcripts, UpdateGtfParams


def _str_blob(strs, n):
    """(uint8 buffer, int64 offsets) for n concatenated strings, or None
    when any string is non-ascii (byte offsets would misalign)."""
    lens = np.fromiter((len(s) for s in strs[:n]), np.int64, n)
    b = "".join(strs[:n]).encode()
    if len(b) != int(lens.sum()):
        return None
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    buf = (np.frombuffer(b, np.uint8) if len(b)
           else np.zeros(0, np.uint8))
    return buf, off


def _write_bam_detail_native(bam_T: Transcripts, cname: ChrNames,
                             fp: IO[str]) -> bool:
    """One-call native line formatting (csrc format_detail_c); False when
    unavailable.  Byte-identical to the python path (tests/test_summary_
    native.py)."""
    from ..native import get_lib
    lib = get_lib()
    n = bam_T.n
    if lib is None or n == 0:
        return False
    blobs = [_str_blob(bam_T.trans_name, n), _str_blob(bam_T.gene_id, n),
             _str_blob(bam_T.gene_name, n),
             _str_blob(list(cname.names), len(cname.names))]
    if any(b is None for b in blobs):
        return False
    (nb, no), (gb, go), (gnb, gno), (cb, co) = blobs
    en = np.ascontiguousarray(bam_T.exon_n[:n])
    en64 = en.astype(np.int64)
    str_bytes = (np.diff(no) + np.diff(go) + np.diff(gno)).sum() + \
        int(np.diff(co)[bam_T.tid[:n]].sum())
    cap = int(str_bytes + n * 96 + (en64 * 24).sum() +
              ((en64 + 4 * np.maximum(en64 - 1, 0)) * 13).sum()) + 64
    out = np.empty(cap, np.uint8)
    wrote = int(lib.format_detail_c(
        nb, no, gb, go, gnb, gno, cb, co,
        np.ascontiguousarray(bam_T.tid[:n]),
        np.ascontiguousarray(bam_T.is_rev[:n]).view(np.uint8),
        np.ascontiguousarray(bam_T.flags["known"][:n]).view(np.uint8),
        np.ascontiguousarray(bam_T.flags["has_known_site"][:n]).view(
            np.uint8),
        en, bam_T.exon_start, bam_T.exon_end, bam_T.exon_start.shape[1],
        bam_T.novel_exon_flag, bam_T.novel_exon_flag.shape[1],
        bam_T.novel_site_flag, bam_T.novel_site_flag.shape[1],
        bam_T.novel_junction_flag, bam_T.novel_junction_flag.shape[1],
        bam_T.unreliable_junction_flag,
        bam_T.unreliable_junction_flag.shape[1],
        n, out, cap))
    if wrote < 0:
        return False
    bio = getattr(fp, "buffer", None)
    if bio is not None:
        fp.flush()
        bio.write(out[:wrote].tobytes())
    else:
        fp.write(out[:wrote].tobytes().decode())
    return True


def write_bam_detail(bam_T: Transcripts, cname: ChrNames, fp: IO[str]) -> None:
    """Per-read 17-column novelty report (reference update_gtf.c:297-419)."""
    fp.write(
        "ReadName\tchr\tstrand\tNovel\tGeneID\tGeneName\tExonCount\tExonStart\t"
        "ExonEnd\tNovelExonCount\tNovelExonIndex\tNovelSiteCount\tNovelSiteIndex\t"
        "NovelJunctionCount\tNovelJunctionIndex\tUnreliableJunctionCount\t"
        "UnreliableJunctionIndex\n")
    if bam_T.n > 2000 and _write_bam_detail_native(bam_T, cname, fp):
        return
    na = "NA"
    n = bam_T.n
    # vectorized pre-pass: flag counts per row (the per-row nonzero calls
    # cost ~4 x n python/numpy crossings; most rows have zero set flags)
    col_e = np.arange(bam_T.novel_exon_flag.shape[1])[None, :]
    col_s = np.arange(bam_T.novel_site_flag.shape[1])[None, :]
    col_j = np.arange(bam_T.novel_junction_flag.shape[1])[None, :]
    en_all = bam_T.exon_n[:n, None]
    ne_cnt = (bam_T.novel_exon_flag[:n] * (col_e < en_all)).sum(1)
    ns_cnt = (bam_T.novel_site_flag[:n] * (col_s < 2 * (en_all - 1))).sum(1)
    nj_cnt = (bam_T.novel_junction_flag[:n] * (col_j < en_all - 1)).sum(1)
    uj_cnt = (bam_T.unreliable_junction_flag[:n] *
              (col_j < en_all - 1)).sum(1)
    parts = []
    for i in range(n):
        en = int(bam_T.exon_n[i])
        if bam_T.flags["known"][i]:
            novel = 0
        elif bam_T.flags["has_known_site"][i]:
            novel = 1
        else:
            novel = 2
        strand = "-" if bam_T.is_rev[i] else "+"
        es, ee = bam_T.exons(i)
        cols = [
            bam_T.trans_name[i], cname[int(bam_T.tid[i])], strand, str(novel),
            bam_T.gene_id[i], bam_T.gene_name[i], str(en),
            ",".join(str(int(x)) for x in es),
            ",".join(str(int(x)) for x in ee),
        ]

        def _flag_cols(cnt: int, flags: np.ndarray) -> Tuple[str, str]:
            if cnt == 0:
                return "0", na
            idx = np.nonzero(flags)[0]
            return str(cnt), ",".join(str(int(j)) for j in idx)

        cols += _flag_cols(int(ne_cnt[i]), bam_T.novel_exon_flag[i, :en])
        cols += _flag_cols(int(ns_cnt[i]),
                           bam_T.novel_site_flag[i, : (en - 1) * 2])
        cols += _flag_cols(int(nj_cnt[i]),
                           bam_T.novel_junction_flag[i, : en - 1])
        cols += _flag_cols(int(uj_cnt[i]),
                           bam_T.unreliable_junction_flag[i, : en - 1])
        if int(uj_cnt[i]) == 0:
            # faithful byte quirk (update_gtf.c:404-414): an empty last
            # column prints "NA\t" (its tab kept) while a non-empty index
            # list drops the trailing tab — empty-16 lines end "NA\t\n"
            cols.append("")
        parts.append("\t".join(cols))
        if len(parts) >= 8192:
            fp.write("\n".join(parts) + "\n")
            parts.clear()
    if parts:
        fp.write("\n".join(parts) + "\n")


class _SimpGenes:
    """Backward-scan gene dedup keyed on gene_id (reference update_gtf.c:176-203)."""

    def __init__(self):
        self.gene_id: List[str] = []
        self.tid: List[int] = []

    def add(self, tid: int, gene_id: str) -> None:
        for i in range(len(self.gene_id) - 1, -1, -1):
            if self.gene_id[i] == gene_id:
                return
            if tid > self.tid[i]:
                break
        self.tid.append(tid)
        self.gene_id.append(gene_id)

    @property
    def n(self) -> int:
        return len(self.gene_id)


class _SimpExons:
    """Exact-coordinate exon dedup accumulating coverage score
    (reference update_gtf.c:205-235)."""

    def __init__(self):
        self.tid: List[int] = []
        self.is_rev: List[int] = []
        self.start: List[int] = []
        self.end: List[int] = []
        self.score: List[int] = []
        self.exon_type: List[int] = []

    def add(self, tid: int, is_rev: int, start: int, end: int, cov: int,
            exon_type: int) -> None:
        for i in range(len(self.tid) - 1, -1, -1):
            if (self.tid[i] == tid and self.start[i] == start and
                    self.end[i] == end):
                self.score[i] += cov
                return
            if tid > self.tid[i]:
                break
        self.tid.append(tid)
        self.is_rev.append(is_rev)
        self.start.append(start)
        self.end.append(end)
        self.score.append(cov)
        self.exon_type.append(exon_type)

    @property
    def n(self) -> int:
        return len(self.tid)


class _SimpSites:
    """(tid, site) dedup (reference update_gtf.c:237-264)."""

    def __init__(self):
        self.tid: List[int] = []
        self.site: List[int] = []

    def add(self, tid: int, site: int) -> None:
        for i in range(len(self.tid) - 1, -1, -1):
            if self.tid[i] == tid and self.site[i] == site:
                return
            if tid > self.tid[i]:
                break
        self.tid.append(tid)
        self.site.append(site)

    @property
    def n(self) -> int:
        return len(self.tid)


class _SimpSJs:
    """(tid, don, acc) dedup (reference update_gtf.c:266-295)."""

    def __init__(self):
        self.tid: List[int] = []
        self.don: List[int] = []
        self.acc: List[int] = []

    def add(self, tid: int, don: int, acc: int) -> None:
        for i in range(len(self.tid) - 1, -1, -1):
            if self.tid[i] == tid and self.don[i] == don and self.acc[i] == acc:
                return
            if tid > self.tid[i]:
                break
        self.tid.append(tid)
        self.don.append(don)
        self.acc.append(acc)

    @property
    def n(self) -> int:
        return len(self.tid)


def write_trans_summary(
    anno_T: Transcripts, updated_T: Transcripts, bam_T: Transcripts,
    ugp: UpdateGtfParams, cname: ChrNames,
    summary_fp: Optional[IO[str]], novel_exon_fp: Optional[IO[str]],
) -> dict:
    """Summary statistics + novel-exon BED (reference update_gtf.c:421-587).

    Returns the stats dict (handy for tests / pipeline metrics).
    """
    genes = _SimpGenes()
    novel_exons = _SimpExons()
    novel_don = _SimpSites()
    novel_acc = _SimpSites()
    novel_junc = _SimpSJs()

    updated_partial = 0
    for i in range(updated_T.n):
        en = int(updated_T.exon_n[i])
        genes.add(int(updated_T.tid[i]), updated_T.gene_id[i])
        updated_partial += int(updated_T.flags["partial_read"][i])
        es, ee = updated_T.exons(i)
        for j in range(en):
            if updated_T.novel_exon_flag[i, j]:
                if en > 1:
                    etype = 0 if (j == 0 or j == en - 1) else 1
                else:
                    etype = 2
                novel_exons.add(int(updated_T.tid[i]), int(updated_T.is_rev[i]),
                                int(es[j]), int(ee[j]), int(updated_T.cov[i]),
                                etype)
        for j in range(en - 1):
            if updated_T.novel_site_flag[i, j * 2]:
                novel_don.add(int(updated_T.tid[i]), int(ee[j]))
            if updated_T.novel_site_flag[i, j * 2 + 1]:
                novel_acc.add(int(updated_T.tid[i]), int(es[j + 1]))
            if updated_T.novel_junction_flag[i, j]:
                novel_junc.add(int(updated_T.tid[i]), int(ee[j]), int(es[j + 1]))
    updated_gene_n = genes.n
    updated_trans_n = updated_T.n
    updated_full = updated_trans_n - updated_partial

    # known / novel / unrecognized tallies with uniq counts
    uniq_known = Transcripts()
    uniq_reliable = Transcripts()
    uniq_unreliable = Transcripts()
    uniq_unrecog = Transcripts()
    # The reference reuses the G array storage but passes a fresh count
    # (&known_gene_n starting at 0, update_gtf.c:496,506), so the known-gene
    # dedup is independent of the updated-gene entries.
    known_genes = _SimpGenes()
    n = bam_T.n
    f_known = bam_T.flags["known"][:n]
    f_site = bam_T.flags["has_known_site"][:n] & ~f_known
    f_unrel = f_site & bam_T.flags["has_unreliable_junction"][:n]
    cls_known = np.nonzero(f_known)[0]
    cls_unrel = np.nonzero(f_unrel)[0]
    cls_rel = np.nonzero(f_site & ~f_unrel)[0]
    cls_unrec = np.nonzero(~f_known & ~f_site)[0]
    known_n = len(cls_known)
    unreliable_n = len(cls_unrel)
    reliable_n = len(cls_rel)
    unrecog_n = len(cls_unrec)
    for i in cls_known.tolist():
        known_genes.add(int(bam_T.tid[i]), bam_T.gene_id[i])
    from ..transcript.merge import merge_candidates_batch
    for idx, uT in ((cls_known, uniq_known), (cls_unrel, uniq_unreliable),
                    (cls_rel, uniq_reliable), (cls_unrec, uniq_unrecog)):
        if merge_candidates_batch(bam_T, idx, uT, ugp.force_strand,
                                  ugp.ss_dis, ugp.end_dis,
                                  ugp.single_exon_ovlp_frac) is None:
            for i in idx.tolist():
                if not merge_trans(bam_T, i, uT, ugp.force_strand,
                                   ugp.ss_dis, ugp.end_dis,
                                   ugp.single_exon_ovlp_frac):
                    uT.append_from(bam_T, i)
    known_gene_n = known_genes.n

    stats = {
        "Genes_of_annotation_GTF": anno_T.gene_n,
        "Transcripts_of_annotation_GTF": anno_T.n,
        "Updated_Genes": updated_gene_n,
        "Added_Novel_Transcripts": updated_full + updated_partial,
        "Added_Novel_Full-read_Transcripts": updated_full,
        "Added_Novel_Partial-read_Transcripts": updated_partial,
        "Added_Novel_Exons": novel_exons.n,
        "Added_Novel_Sites": novel_don.n + novel_acc.n,
        "Added_Novel_Splice_Junctions": novel_junc.n,
        "Known_Transcripts_from_BAM": known_n,
        "Genes_of_Known_Transcripts_from_BAM": known_gene_n,
        "Uniq_Known_Transcripts_from_BAM": uniq_known.n,
        "Novel_Transcript_from_BAM": reliable_n + unreliable_n,
        "Novel_Transcript_from_BAM_with_All_Reliable_Junction": reliable_n,
        "Uniq_Novel_Transcript_from_BAM_with_All_Reliable_Junction": uniq_reliable.n,
        "Novel_Transcript_from_BAM_with_Unreliable_Junction": unreliable_n,
        "Uniq_Novel_Transcript_from_BAM_with_Unreliable_Junction": uniq_unreliable.n,
        "Unrecognized_Transcript_from_BAM": unrecog_n,
        "Uniq_Unrecognized_Transcript_from_BAM": uniq_unrecog.n,
    }

    if summary_fp:
        w = summary_fp.write
        w("==== Annotaion ====\n")
        w(f"Genes_of_annotation_GTF\t{stats['Genes_of_annotation_GTF']}\n")
        w(f"Transcripts_of_annotation_GTF\t{stats['Transcripts_of_annotation_GTF']}\n")
        w("\n===================\n")
        w("\n==== Updated information ====\n")
        w(f"Updated_Genes\t{stats['Updated_Genes']}\n")
        w(f"Added_Novel_Transcripts\t{stats['Added_Novel_Transcripts']}\n")
        w(f"Added_Novel_Full-read_Transcripts\t{stats['Added_Novel_Full-read_Transcripts']}\n")
        w(f"Added_Novel_Partial-read_Transcripts\t{stats['Added_Novel_Partial-read_Transcripts']}\n")
        w(f"Added_Novel_Exons\t{stats['Added_Novel_Exons']}\n")
        w(f"Added_Novel_Sites\t{stats['Added_Novel_Sites']}\n")
        w(f"Added_Novel_Splice_Junctions\t{stats['Added_Novel_Splice_Junctions']}\n")
        w("\n=============================\n")
        w("\n==== Known information ====\n")
        w(f"Known_Transcripts_from_BAM\t{stats['Known_Transcripts_from_BAM']}\n")
        w(f"Genes_of_Known_Transcripts_from_BAM\t{stats['Genes_of_Known_Transcripts_from_BAM']}\n")
        w(f"Uniq_Known_Transcripts_from_BAM\t{stats['Uniq_Known_Transcripts_from_BAM']}\n")
        w("\n===========================\n")
        w("\n==== Novel information ====\n")
        w(f"Novel_Transcript_from_BAM\t{stats['Novel_Transcript_from_BAM']}\n")
        w(f"Novel_Transcript_from_BAM_with_All_Reliable_Junction\t{stats['Novel_Transcript_from_BAM_with_All_Reliable_Junction']}\n")
        w(f"Uniq_Novel_Transcript_from_BAM_with_All_Reliable_Junction\t{stats['Uniq_Novel_Transcript_from_BAM_with_All_Reliable_Junction']}\n")
        w(f"Novel_Transcript_from_BAM_with_Unreliable_Junction\t{stats['Novel_Transcript_from_BAM_with_Unreliable_Junction']}\n")
        w(f"Uniq_Novel_Transcript_from_BAM_with_Unreliable_Junction\t{stats['Uniq_Novel_Transcript_from_BAM_with_Unreliable_Junction']}\n")
        w("\n===========================\n")
        w("\n==== Unrecognized information ====\n")
        w(f"Unrecognized_Transcript_from_BAM\t{stats['Unrecognized_Transcript_from_BAM']}\n")
        w(f"Uniq_Unrecognized_Transcript_from_BAM\t{stats['Uniq_Unrecognized_Transcript_from_BAM']}\n")
        w("\n==================================\n")

    if novel_exon_fp:
        # chrom  start0base  end1base  name  count  strand
        for i in range(novel_exons.n):
            novel_exon_fp.write(
                f"{cname[novel_exons.tid[i]]}\t{novel_exons.start[i] - 1}\t"
                f"{novel_exons.end[i]}\t{'TIS'[novel_exons.exon_type[i]]}_exon\t"
                f"{novel_exons.score[i]}\t{'+-'[novel_exons.is_rev[i]]}\n")

    return stats
