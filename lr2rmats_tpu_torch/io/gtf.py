"""GTF reading/writing with reference-identical semantics and byte formats.

Reader mirrors read_anno_trans / read_gtf_trans (reference gtf.c:468-595):
only "exon" lines are consumed; a transcript ends when transcript_id changes;
gene_n counts id *transitions* (not unique ids); gene_id/gene_name and
transcript_id/transcript_name back-fill each other when one is missing.

Writer mirrors print_read_trans (reference gtf.c:607-632) byte-for-byte:
attribute order gene_id, transcript_id, gene_name, transcript_name (only
non-empty ones), transcript lines add transcript_cov, and exon lines are
emitted in reverse order for '-'-strand transcripts.
"""

from __future__ import annotations

import re
from typing import Dict, IO, List, Optional, Tuple

import numpy as np

from ..transcript.model import Transcripts
from ..utils import log


class ChrNames:
    """Chromosome-name registry (reference chr_name_t, gtf.c:336-412).

    Built from the alignment-header target list first (bam_set_cname),
    then extended on demand (get_chr_id).
    """

    def __init__(self, names: Optional[List[str]] = None):
        self.names: List[str] = []
        self._idx: Dict[str, int] = {}
        for nm in names or []:
            self.get_id(nm)

    def get_id(self, name: str) -> int:
        i = self._idx.get(name)
        if i is None:
            i = len(self.names)
            self.names.append(name)
            self._idx[name] = i
        return i

    def lookup(self, name: str) -> Optional[int]:
        return self._idx.get(name)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> str:
        return self.names[i]


_ATTR_RE_CACHE: Dict[str, re.Pattern] = {}


def _attr(add_info: str, tag: str) -> str:
    """Extract `tag "value"` from the GTF attribute column (reference
    gtf_add_info, gtf.c:317-326: first occurrence of the tag substring,
    value up to the next '"')."""
    pat = _ATTR_RE_CACHE.get(tag)
    if pat is None:
        pat = re.compile(re.escape(tag) + r'..([^"]*)')
        _ATTR_RE_CACHE[tag] = pat
    m = pat.search(add_info)
    return m.group(1) if m else ""


def _read_gtf(path: str, cname: ChrNames, T: Transcripts, as_read_trans: bool) -> int:
    """Shared body of read_anno_trans / read_gtf_trans.

    as_read_trans=True initializes the all-novel flag arrays the way
    read_gtf_trans does (reference gtf.c:555-566) so the transcripts can act
    as classification inputs; False reads annotation style (gtf.c:468-521).
    """
    log("read_gtf", "reading transcript annotation from %s ...", path)
    last_tid_name = ""
    last_gid = ""
    cur: Optional[dict] = None

    def _flush(c: dict) -> None:
        es = np.array(c["estart"], np.int32)
        ee = np.array(c["eend"], np.int32)
        order = np.lexsort((ee, es))  # sort_exon: by (start, end)
        es, ee = es[order], ee[order]
        T.append(
            c["tid"], c["is_rev"], es, ee,
            gene_id=c["gid"], gene_name=c["gname"],
            trans_id=c["trans_id"], trans_name=c["trans_name"],
            init_novel=as_read_trans,
        )

    with open(path) as fp:
        for line in fp:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9 or f[2] != "exon":
                continue
            ref, start, end, strand, add_info = f[0], int(f[3]), int(f[4]), f[6], f[8]
            is_rev = strand == "-"
            tid = cname.get_id(ref)

            gid = _attr(add_info, "gene_id")
            gname = _attr(add_info, "gene_name")
            if not gid and not gname:
                raise ValueError(f"GTF format error in {path}: no gene id/name")
            if not gid:
                gid = gname
            elif not gname:
                gname = gid
            trans_id = _attr(add_info, "transcript_id")
            trans_name = _attr(add_info, "transcript_name")
            if not trans_id and not trans_name:
                raise ValueError(f"GTF format error in {path}: no transcript id/name")
            if not trans_id:
                trans_id = trans_name
            elif not trans_name:
                trans_name = trans_id

            # gene_n counts transitions of the gene key (reference gtf.c:495
            # keys on gene_id for annotation; gtf.c:553 keys on gene_name for
            # read-trans input; the distinction is preserved here).
            gkey = gname if as_read_trans else gid
            if gkey != last_gid:
                T.gene_n += 1
                last_gid = gkey
            if trans_id != last_tid_name:
                if cur is not None and len(cur["estart"]) >= 1:
                    _flush(cur)
                cur = dict(tid=tid, is_rev=is_rev, gid=gid, gname=gname,
                           trans_id=trans_id, trans_name=trans_name,
                           estart=[], eend=[])
                last_tid_name = trans_id
            cur["estart"].append(start)
            cur["eend"].append(end)

    if cur is not None and len(cur["estart"]) >= 1:
        _flush(cur)
    log("read_gtf", "reading transcript annotation from %s done.", path)
    return T.n


def read_anno_trans(path: str, cname: ChrNames, T: Optional[Transcripts] = None) -> Transcripts:
    """Annotation reader (reference read_anno_trans, gtf.c:468-521)."""
    if T is None:
        T = Transcripts()
    _read_gtf(path, cname, T, as_read_trans=False)
    return T


def read_gtf_trans(path: str, cname: ChrNames, T: Optional[Transcripts] = None) -> Transcripts:
    """Read-transcript GTF reader with all-novel flag init (reference
    read_gtf_trans, gtf.c:524-595)."""
    if T is None:
        T = Transcripts()
    _read_gtf(path, cname, T, as_read_trans=True)
    return T


def _attrs(gene_id: str, trans_id: str, gene_name: str, trans_name: str) -> str:
    parts = []
    if gene_id:
        parts.append(f'gene_id "{gene_id}";')
    if trans_id:
        parts.append(f'transcript_id "{trans_id}";')
    if gene_name:
        parts.append(f'gene_name "{gene_name}";')
    if trans_name:
        parts.append(f'transcript_name "{trans_name}";')
    return " ".join(parts)


def write_trans_simple(T: Transcripts, i: int, cname: ChrNames, src: str,
                       out: IO[str]) -> None:
    """Single-transcript writer matching print_trans (reference
    gtf.c:597-604): only gene_id + transcript_id attributes, exons in stored
    (coordinate) order for both strands."""
    chrom = cname[int(T.tid[i])]
    strand = "-" if T.is_rev[i] else "+"
    attr = f'gene_id "{T.gene_id[i]}"; transcript_id "{T.trans_id[i]}";'
    out.write(f"{chrom}\t{src}\ttranscript\t{int(T.start[i])}\t{int(T.end[i])}"
              f"\t.\t{strand}\t.\t{attr}\n")
    for j in range(int(T.exon_n[i])):
        out.write(f"{chrom}\t{src}\texon\t{int(T.exon_start[i, j])}\t"
                  f"{int(T.exon_end[i, j])}\t.\t{strand}\t.\t{attr}\n")


def _write_read_trans_native(T: Transcripts, cname: ChrNames, src: str,
                             out: IO[str]) -> bool:
    """Native GTF line formatting (csrc format_gtf_c); False when the
    native lib is unavailable.  Attribute strings are built here (they
    carry python name data), numbers format in C — the f-string path cost
    ~4 us/line over millions of lines at 500k-read scale."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None or T.n == 0:
        return False
    import numpy as np
    n = T.n
    attrs = [
        _attrs(T.gene_id[i], T.trans_id[i], T.gene_name[i],
               T.trans_name[i]).encode()
        for i in range(n)
    ]
    attr_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(a) for a in attrs], out=attr_off[1:])
    attr_buf = np.frombuffer(b"".join(attrs), np.uint8) if attrs else \
        np.zeros(0, np.uint8)
    chroms = [cname[i].encode() for i in range(len(cname.names))]
    chrom_off = np.zeros(len(chroms) + 1, np.int64)
    np.cumsum([len(c) for c in chroms], out=chrom_off[1:])
    chrom_buf = np.frombuffer(b"".join(chroms), np.uint8) if chroms else \
        np.zeros(0, np.uint8)
    srcb = np.frombuffer(src.encode(), np.uint8)
    en = T.exon_n[:n]
    attr_len = np.diff(attr_off)
    chrom_len = np.diff(chrom_off)[T.tid[:n]]
    cap = int(np.sum((en.astype(np.int64) + 1) *
                     (chrom_len + len(srcb) + attr_len + 96))) + 64
    buf = np.empty(cap, np.uint8)
    wrote = int(lib.format_gtf_c(
        chrom_buf, chrom_off, srcb, len(srcb),
        np.ascontiguousarray(T.tid[:n]), np.ascontiguousarray(T.is_rev[:n]),
        np.ascontiguousarray(T.start[:n]), np.ascontiguousarray(T.end[:n]),
        np.ascontiguousarray(T.cov[:n]),
        T.exon_start, T.exon_end, T.exon_start.shape[1],
        np.ascontiguousarray(en),
        attr_buf, attr_off, n, buf, cap))
    if wrote < 0:
        return False
    # write BYTES: round-tripping a multi-hundred-MB buffer through
    # str (decode + TextIOWrapper re-encode) cost ~7 s at 500k reads
    bio = getattr(out, "buffer", None)
    if bio is not None:
        out.flush()
        bio.write(buf[:wrote].tobytes())
    else:
        out.write(buf[:wrote].tobytes().decode())
    return True


def write_read_trans(T: Transcripts, cname: ChrNames, src: str, out: IO[str]) -> None:
    """GTF writer, byte-identical to print_read_trans (reference gtf.c:607-632).

    Lines are accumulated and flushed in chunks — at 100k+ transcripts the
    per-write overhead dominates otherwise."""
    if T.n > 2000 and _write_read_trans_native(T, cname, src, out):
        return
    parts = []
    for i in range(T.n):
        chrom = cname[int(T.tid[i])]
        strand = "-" if T.is_rev[i] else "+"
        exon_attr = _attrs(T.gene_id[i], T.trans_id[i], T.gene_name[i], T.trans_name[i])
        trans_attr = f'{exon_attr} transcript_cov "{int(T.cov[i])}";'
        parts.append(f"{chrom}\t{src}\ttranscript\t{int(T.start[i])}\t{int(T.end[i])}\t.\t{strand}\t.\t{trans_attr}\n")
        en = int(T.exon_n[i])
        idx = range(en - 1, -1, -1) if T.is_rev[i] else range(en)
        for j in idx:
            parts.append(
                f"{chrom}\t{src}\texon\t{int(T.exon_start[i, j])}\t{int(T.exon_end[i, j])}"
                f"\t.\t{strand}\t.\t{exon_attr}\n")
        if len(parts) >= 8192:
            out.write("".join(parts))
            parts.clear()
    out.write("".join(parts))
