"""CIGAR -> exon-chain conversion (bam2gtf semantics).

gen_exon (reference bam2gtf.c:31-78): N ops >= min_intron and D ops >
max_delet open new exons; internal exons shorter than min_exon are dropped;
strand comes from the XS aux tag when present, else the FLAG; the final exon
is always emitted.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from ..io.sam import AlnRec, OP_D, OP_EQ, OP_M, OP_N, OP_X
from .model import Transcripts


def gen_exons(rec: AlnRec, min_exon: int, min_intron: int, max_delet: int):
    """Returns (starts, ends, is_rev) — 1-based inclusive exon intervals."""
    start = rec.pos + 1
    end = start - 1
    xs = rec.tags.get("XS")
    if xs is None:
        is_rev = rec.is_rev
    else:
        is_rev = xs != "+"
    starts, ends = [], []
    for c in rec.cigar:
        op = int(c) & 0xF
        l = int(c) >> 4
        if op == OP_N:
            if l >= min_intron:
                if not starts or (end - start + 1) >= min_exon:
                    starts.append(start)
                    ends.append(end)
                start = end + l + 1
            end += l
        elif op == OP_D:
            if l > max_delet:
                if not starts or (end - start + 1) >= min_exon:
                    starts.append(start)
                    ends.append(end)
                start = end + l + 1
            end += l
        elif op in (OP_M, OP_EQ, OP_X):
            end += l
        # I/S/H/P/B consume no reference
    starts.append(start)
    ends.append(end)
    return np.asarray(starts, np.int32), np.asarray(ends, np.int32), is_rev


def read_sam_trans_native(path: str, min_exon: int, min_intron: int,
                          max_delet: int) -> Optional[Transcripts]:
    """Bulk SAM-text -> Transcripts via the native scanner
    (csrc sam_to_exons_c + Transcripts.append_batch); returns None when not
    applicable (BAM input / native lib unavailable).  Agreement-tested
    against the record-wise path in tests/test_native.py."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    from ..utils.fileio import read_into_array
    buf = read_into_array(path)
    if buf[:2].tobytes() == b"\x1f\x8b":
        return None
    import ctypes
    from ..utils.fileio import count_newlines
    cap_rec = count_newlines(buf) + 1
    cap_exon = 4 * cap_rec + len(buf) // 64 + 16
    rec_tid = np.zeros(cap_rec, np.int32)
    rec_rev = np.zeros(cap_rec, np.uint8)
    rec_eoff = np.zeros(cap_rec, np.int64)
    rec_qoff = np.zeros(cap_rec, np.int64)
    rec_qlen = np.zeros(cap_rec, np.int32)
    es = np.zeros(cap_exon, np.int32)
    ee = np.zeros(cap_exon, np.int32)
    etot = ctypes.c_int64()
    nr = lib.sam_to_exons_c(buf, len(buf), min_exon, min_intron, max_delet,
                            cap_rec, cap_exon, rec_tid, rec_rev, rec_eoff,
                            rec_qoff, rec_qlen, es, ee, ctypes.byref(etot))
    if int(etot.value) >= cap_exon:  # capacity overflow: fall back
        return None
    T = Transcripts(cap=max(int(nr), 1))
    exon_off = np.concatenate([rec_eoff[:nr], [int(etot.value)]]).astype(np.int64)
    # ONE compact gather + ONE decode for all names (a per-name
    # tobytes().decode() loop cost ~5 s at 500k records)
    ql = rec_qlen[:nr].astype(np.int64)
    noffs = np.zeros(nr + 1, np.int64)
    np.cumsum(ql, out=noffs[1:])
    src = (np.repeat(rec_qoff[:nr], ql) +
           (np.arange(int(noffs[-1])) - np.repeat(noffs[:-1], ql)))
    blob = buf[src].tobytes().decode("ascii", "replace")
    names = [blob[noffs[i]: noffs[i + 1]] for i in range(nr)]
    T.append_batch(rec_tid[:nr], rec_rev[:nr], es[: int(etot.value)],
                   ee[: int(etot.value)], exon_off, names)
    return T


def read_bam_trans(records: Iterable[AlnRec], min_exon: int, min_intron: int,
                   max_delet: int, T: Optional[Transcripts] = None) -> Transcripts:
    """Alignment stream -> all-novel-flagged transcripts (reference
    read_bam_trans, bam2gtf.c:89-110).  Unmapped records are skipped (the
    reference would NULL-deref on them; its pipeline inputs never contain
    any)."""
    if T is None:
        T = Transcripts()
    for rec in records:
        if rec.is_unmapped:
            continue
        starts, ends, is_rev = gen_exons(rec, min_exon, min_intron, max_delet)
        T.append(rec.tid, is_rev, starts, ends,
                 gene_id=rec.qname, gene_name=rec.qname,
                 trans_id=rec.qname, trans_name=rec.qname,
                 init_novel=True)
    return T
