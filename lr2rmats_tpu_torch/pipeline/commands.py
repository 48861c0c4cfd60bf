"""File-level drivers for the six subcommands.

Each mirrors a reference CLI entry (reference main.c:37-49):
filter / fusion / update-gtf / unique-gtf / bam2gtf / bam2sj — operating on
SAM/BAM/GTF paths, so the CLI surface matches the reference binary's.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import List, Optional

import numpy as np

from .. import PROG
from ..io.fasta import Genome
from ..io.gtf import ChrNames, read_anno_trans, read_gtf_trans, write_read_trans
from ..io.sam import AlnRec, SamWriter, open_alignments, write_bam
from ..io.sj import read_sj_group, write_sj
from ..junctions.bam2sj import bam2sj_records
from ..transcript.classify import check_trans
from ..transcript.exon_chain import read_bam_trans
from ..transcript.filter import FilterParams, filter_alignments
from ..transcript.fusion import FusionParams, detect_fusions
from ..transcript.merge import uniq_trans
from ..transcript.model import Transcripts, UpdateGtfParams
from ..report.summary import write_bam_detail, write_trans_summary


@contextmanager
def _out(path: Optional[str]):
    if path is None or path == "-":
        yield sys.stdout
    else:
        f = open(path, "w")
        try:
            yield f
        finally:
            f.close()


def _filter_sam_native(in_path: Optional[str], params: FilterParams,
                       rm_gtf: Optional[str],
                       data: Optional[np.ndarray] = None) -> Optional[tuple]:
    """Native streaming scan over SAM text: returns (refs, header, buf,
    (keep_off, keep_len, keep_tid, keep_pos), reader) — raw byte spans
    into `buf`, NOT parsed records — or None when not applicable (BAM
    input / no native lib).
    Agreement-tested against the Python path (tests/test_native.py).
    `data` (uint8 array of SAM text) bypasses the file read — the
    rb-direct path filters the align stage's in-memory bytes so the
    multi-hundred-MB SAM artifact is never read back (cold-path IO)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    if data is not None:
        buf = data
    else:
        from ..utils.fileio import read_into_array
        buf = read_into_array(in_path)      # uint8 array (decode/copy of
    if buf[:2].tobytes() == b"\x1f\x8b":    # the whole file pays ~150 MB/s
        return None                          # first-touch cost again)
    import ctypes
    from ..io.sam import SamReader
    import io as _io
    # decode only the @-header prefix for refs/header parsing
    pref_n = 1 << 20
    while True:
        pref = buf[: pref_n].tobytes()
        hdr_end = 0
        while hdr_end < len(pref) and pref[hdr_end: hdr_end + 1] == b"@":
            nl = pref.find(b"\n", hdr_end)
            if nl < 0:
                hdr_end = len(pref)
                break
            hdr_end = nl + 1
        if hdr_end < len(pref) or pref_n >= len(buf):
            break
        pref_n *= 2
    rd = SamReader(_io.StringIO(pref[:hdr_end].decode()))
    refs, header = rd.refs, rd.header_lines
    if rm_gtf:
        cname = ChrNames([n for n, _ in refs])
        rm = read_anno_trans(rm_gtf, cname)
        rm_tid = rm.tid[: rm.n].astype(np.int64)
        rm_start = rm.start[: rm.n].astype(np.int64)
        rm_end = rm.end[: rm.n].astype(np.int64)
    else:
        rm_tid = rm_start = rm_end = np.zeros(0, np.int64)
    # chunked newline count: `buf == 10` on a GB-scale SAM buffer would
    # materialize a same-size bool temporary (doubling peak RSS on the
    # exact path built to avoid large-buffer costs)
    from ..utils.fileio import count_newlines
    cap = 1 + count_newlines(buf)
    keep_off = np.zeros(cap, np.int64)
    keep_len = np.zeros(cap, np.int64)
    keep_tid = np.zeros(cap, np.int64)
    keep_pos = np.zeros(cap, np.int64)
    from ..utils import default_threads
    kept_n = lib.filter_sam_c(
        buf, len(buf), params.cov_rate, params.map_qual, params.sec_rat,
        params.min_intron_n,
        np.ascontiguousarray(rm_tid), np.ascontiguousarray(rm_start),
        np.ascontiguousarray(rm_end), len(rm_tid),
        keep_off, keep_len, keep_tid, keep_pos, cap,
        default_threads())
    spans = (keep_off[:kept_n], keep_len[:kept_n], keep_tid[:kept_n],
             keep_pos[:kept_n])
    return refs, header, buf, spans, rd


def cmd_filter(in_path: Optional[str], out_path: Optional[str],
               params: FilterParams,
               rm_gtf: Optional[str] = None, out_format: str = "bam",
               sort_output: bool = True,
               data: Optional[np.ndarray] = None) -> int:
    """`filter` (reference bam_filter.c:98-164) + the downstream
    `samtools sort` role (Snakefile:90-92) via sort_output.

    `data`: in-memory SAM bytes (uint8) — the rb-direct path used by the
    pipeline's align stage, avoiding the artifact re-read (native path
    only; a file path is still required as fallback when the native lib
    is unavailable)."""
    native = _filter_sam_native(in_path, params, rm_gtf, data=data)
    if native is not None:
        refs, header, buf, spans, rd = native
        from ..utils import log
        log("bam_filter", "Filtered alignments: %d", len(spans[0]))
        keep_off, keep_len, keep_tid, keep_pos = spans
        if out_format == "sam":
            # raw-span fast path: (tid, pos) came out of the native scan,
            # so ordering is one lexsort; lines batch into ~16 MB writes
            # (1M per-span write() calls cost ~14 s at 500k records)
            if sort_output:
                order = np.lexsort((keep_pos, keep_tid))
                keep_off = keep_off[order]
                keep_len = keep_len[order]
            nl = np.frombuffer(b"\n", np.uint8)
            import contextlib
            # honor the _out() stdout convention (None / "-"): the
            # fallback path streams to stdout, so the native path must too
            sink = (open(out_path, "wb") if out_path and out_path != "-"
                    else contextlib.nullcontext(sys.stdout.buffer))
            with sink as f:
                f.write(("\n".join(header) + "\n").encode()
                        if header else b"")
                batch = []
                bsz = 0
                for off, ln in zip(keep_off.tolist(), keep_len.tolist()):
                    batch.append(buf[off: off + ln])
                    batch.append(nl)
                    bsz += ln + 1
                    if bsz >= (1 << 24):
                        f.write(b"".join([m.tobytes() for m in batch]))
                        batch.clear()
                        bsz = 0
                if batch:
                    f.write(b"".join([m.tobytes() for m in batch]))
            return len(keep_off)
        kept = [rd._parse(buf[off: off + ln].tobytes().decode())
                for off, ln in zip(keep_off.tolist(), keep_len.tolist())]
    else:
        refs, header, records = open_alignments(in_path)
        rm = None
        if rm_gtf:
            cname = ChrNames([n for n, _ in refs])
            rm = read_anno_trans(rm_gtf, cname)
        kept = list(filter_alignments(records, params, rm))
    if sort_output:
        kept.sort(key=lambda r: (r.tid, r.pos))
    if out_format == "bam":
        write_bam(out_path or "out.bam", refs, header or None, kept)
    else:
        with _out(out_path) as f:
            w = SamWriter(f, refs, header or None)
            for r in kept:
                w.write(r)
    return len(kept)


def _load_input_trans(in_path: str, input_mode: str, hdr_bam: Optional[str],
                      ugp_min_exon: int, ugp_min_intron: int,
                      ugp_max_delet: int):
    """Shared input ingest of update-gtf / unique-gtf (BAM or GTF mode)."""
    if input_mode == "bam":
        from ..transcript.exon_chain import read_sam_trans_native
        T = read_sam_trans_native(in_path, ugp_min_exon, ugp_min_intron,
                                  ugp_max_delet)
        if T is not None:
            refs, _, _ = open_alignments(in_path)
            return ChrNames([n for n, _ in refs]), T
        refs, _, records = open_alignments(in_path)
        cname = ChrNames([n for n, _ in refs])
        bam_T = read_bam_trans(records, ugp_min_exon, ugp_min_intron,
                               ugp_max_delet)
    else:
        if hdr_bam is None:
            raise ValueError("GTF input mode requires a BAM/SAM for header "
                             "information (-b)")
        refs, _, _ = open_alignments(hdr_bam)
        cname = ChrNames([n for n, _ in refs])
        bam_T = read_gtf_trans(in_path, cname)
    return cname, bam_T


def cmd_update_gtf(in_path: str, anno_path: str, ugp: UpdateGtfParams,
                   hdr_bam: Optional[str] = None, sj_path: Optional[str] = None,
                   out_path: Optional[str] = None,
                   exon_bed: Optional[str] = None,
                   bam_gtf: Optional[str] = None,
                   bam_detail: Optional[str] = None,
                   known_gtf: Optional[str] = None,
                   novel_gtf: Optional[str] = None,
                   unrecog_gtf: Optional[str] = None,
                   summary: Optional[str] = None,
                   input_cache: Optional[dict] = None) -> dict:
    """`update-gtf` (reference update_gtf.c:995-1117).

    `input_cache`: optional dict shared by the caller across the two
    pipeline passes — the (large) input ingests once and each pass gets an
    independent copy (classification mutates flags in place)."""
    key = (in_path, ugp.input_mode, hdr_bam, ugp.min_exon, ugp.min_intron,
           ugp.max_delet)
    if input_cache is not None and input_cache.get("key") == key:
        cname, bam_T = input_cache["cname"], input_cache["bam_T"].copy()
    else:
        cname, bam_T = _load_input_trans(
            in_path, ugp.input_mode, hdr_bam, ugp.min_exon, ugp.min_intron,
            ugp.max_delet)
        if input_cache is not None:
            input_cache.update(key=key, cname=cname, bam_T=bam_T.copy())
    anno_T = read_anno_trans(anno_path, cname)
    sj = read_sj_group(sj_path, cname)

    updated_T, known_T, novel_T, unrecog_T = (Transcripts() for _ in range(4))
    check_trans(bam_T, anno_T, sj, ugp, updated_T, known_T, novel_T, unrecog_T)

    with _out(out_path) as f:
        write_read_trans(updated_T, cname, ugp.source, f)
    if bam_gtf:
        with _out(bam_gtf) as f:
            write_read_trans(bam_T, cname, ugp.source, f)
    if bam_detail:
        with _out(bam_detail) as f:
            write_bam_detail(bam_T, cname, f)
    if known_gtf:
        with _out(known_gtf) as f:
            write_read_trans(known_T, cname, ugp.source, f)
    if novel_gtf:
        with _out(novel_gtf) as f:
            write_read_trans(novel_T, cname, ugp.source, f)
    if unrecog_gtf:
        with _out(unrecog_gtf) as f:
            write_read_trans(unrecog_T, cname, ugp.source, f)
    stats = {}
    if summary or exon_bed:
        sfp = open(summary, "w") if summary else None
        efp = open(exon_bed, "w") if exon_bed else None
        try:
            stats = write_trans_summary(anno_T, updated_T, bam_T, ugp, cname,
                                        sfp, efp)
        finally:
            if sfp:
                sfp.close()
            if efp:
                efp.close()
    stats.update(dict(updated=updated_T.n, known=known_T.n, novel=novel_T.n,
                      unrecog=unrecog_T.n))
    return stats


def cmd_unique_gtf(in_path: str, ugp: UpdateGtfParams,
                   hdr_bam: Optional[str] = None,
                   out_path: Optional[str] = None,
                   output_intersect: bool = False) -> int:
    """`unique-gtf` (reference unique_gtf.c:86-158).  The reference's
    `device_gather` option, which sends the candidates through its device
    mesh and back unchanged, is left out: it changes no output."""
    cname, bam_T = _load_input_trans(
        in_path, ugp.input_mode, hdr_bam, ugp.min_exon, ugp.min_intron,
        ugp.max_delet)
    uniq_T, shared_T = Transcripts(), Transcripts()
    uniq_trans(bam_T, uniq_T, shared_T, ugp.force_strand, ugp.ss_dis,
               ugp.end_dis, ugp.single_exon_ovlp_frac)
    with _out(out_path) as f:
        write_read_trans(shared_T if output_intersect else uniq_T, cname,
                         ugp.source, f)
    return (shared_T if output_intersect else uniq_T).n


def cmd_bam2gtf(in_path: str, out_path: Optional[str] = None,
                min_exon: int = 3, min_intron: int = 3, max_delet: int = 50,
                source: str = PROG) -> int:
    """`bam2gtf` (reference bam2gtf.c:120-161)."""
    from ..io.gtf import write_trans_simple
    from ..transcript.exon_chain import read_sam_trans_native
    refs, _, records = open_alignments(in_path)
    cname = ChrNames([n for n, _ in refs])
    T = read_sam_trans_native(in_path, min_exon, min_intron, max_delet)
    if T is None:
        T = read_bam_trans(records, min_exon, min_intron, max_delet)
    with _out(out_path) as f:
        for i in range(T.n):
            write_trans_simple(T, i, cname, source, f)
    return T.n


def cmd_bam2sj(in_path: str, genome_path: Optional[str] = None,
               out_path: Optional[str] = None, min_intron: int = 3,
               require_proper_pair: bool = True) -> int:
    """`bam2sj` (reference parse_bam.c:987-1058)."""
    refs, _, records = open_alignments(in_path)
    cname = ChrNames([n for n, _ in refs])
    genome = Genome.load(genome_path) if genome_path else None
    sj = bam2sj_records(records, genome, min_intron,
                        require_proper_pair=require_proper_pair)
    with _out(out_path) as f:
        write_sj(sj, cname, f)
    return sj.n


def cmd_fusion(in_path: str, out_path: Optional[str], params: FusionParams,
               fusion_site: Optional[str] = None, out_format: str = "bam") -> int:
    """`fusion` (reference bam_fusion.c:144-212)."""
    refs, header, records = open_alignments(in_path)
    fs_fp = open(fusion_site, "w") if fusion_site else None
    try:
        kept = list(detect_fusions(records, params, fs_fp,
                                   [n for n, _ in refs]))
    finally:
        if fs_fp:
            fs_fp.close()
    if out_format == "bam":
        write_bam(out_path or "fusion.bam", refs, header or None, kept)
    else:
        with _out(out_path) as f:
            w = SamWriter(f, refs, header or None)
            for r in kept:
                w.write(r)
    return len(kept)
