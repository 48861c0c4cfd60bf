"""Splice-junction table model + STAR-format I/O.

The SJ table is a struct-of-arrays equivalent of sj_t (reference gtf.h:24-28):
tid, don (intron first base), acc (intron last base), strand (0 undefined /
1 '+' / 2 '-'), motif (0 non-canonical, 1 GT/AG, 2 CT/AC, 3 GC/AG, 4 CT/GC,
5 AT/AC, 6 GT/AT), is_anno, uniq_c, multi_c, max_over.

read_sj_group mirrors reference gtf.c:431-449 (9-column STAR SJ.out.tab rows,
then sort by (tid, don, acc)); write_sj mirrors print_sj
(reference parse_bam.c:974-985).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO, Optional

import numpy as np

from .gtf import ChrNames


@dataclass
class SJTable:
    tid: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    don: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    acc: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    strand: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    motif: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    is_anno: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    uniq_c: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    multi_c: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    max_over: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n(self) -> int:
        return len(self.tid)

    def __len__(self) -> int:
        return len(self.tid)

    def sort(self) -> "SJTable":
        order = np.lexsort((self.acc, self.don, self.tid))
        return SJTable(*(getattr(self, f)[order] for f in
                         ("tid", "don", "acc", "strand", "motif", "is_anno",
                          "uniq_c", "multi_c", "max_over")))


def read_sj_group(path: Optional[str], cname: ChrNames) -> SJTable:
    """Parse a STAR SJ.out.tab file (reference read_sj_group, gtf.c:431-449).

    Comment lines (the headers written by our own bam2sj) are skipped; the
    reference's sscanf simply fails to bind ints on them but it also never
    emits them into pipeline inputs.
    """
    if path is None:
        return SJTable()
    cols = ([], [], [], [], [], [], [], [], [])
    with open(path) as fp:
        for line in fp:
            if line.startswith("#"):
                continue
            f = line.split()
            if len(f) < 9:
                continue
            tid = cname.get_id(f[0])
            vals = (tid, int(f[1]), int(f[2]), int(f[3]), int(f[4]),
                    int(f[5]), int(f[6]), int(f[7]), int(f[8]))
            for c, v in zip(cols, vals):
                c.append(v)
    # STAR column order: chrom start end strand motif annotated uniq multi over
    t = SJTable(
        tid=np.asarray(cols[0], np.int32),
        don=np.asarray(cols[1], np.int32),
        acc=np.asarray(cols[2], np.int32),
        strand=np.asarray(cols[3], np.int8),
        motif=np.asarray(cols[4], np.int8),
        is_anno=np.asarray(cols[5], np.int8),
        uniq_c=np.asarray(cols[6], np.int32),
        multi_c=np.asarray(cols[7], np.int32),
        max_over=np.asarray(cols[8], np.int32),
    )
    return t.sort()


def write_sj(sj: SJTable, cname: ChrNames, out: IO[str]) -> None:
    """bam2sj output format (reference print_sj, parse_bam.c:974-985)."""
    out.write("###STRAND 0:undefined, 1:+, 2:-\n")
    out.write("###ANNO 0:novel, 1:annotated\n")
    out.write("###MOTIF 0:non-canonical, 1:GT/AG, 2:CT/AC, 3:GC/AG, 4:CT/GC, 5:AT/AC, 6:GT/AT\n")
    out.write("#CHR\tSTART\tEND\tSTRAND\tANNO\tUNIQ_C\tMULTI_C\tMOTIF\n")
    for i in range(sj.n):
        out.write(f"{cname[int(sj.tid[i])]}\t{int(sj.don[i])}\t{int(sj.acc[i])}\t"
                  f"{int(sj.strand[i])}\t{int(sj.is_anno[i])}\t{int(sj.uniq_c[i])}\t"
                  f"{int(sj.multi_c[i])}\t{int(sj.motif[i])}\n")


def write_sj_star(sj: SJTable, cname: ChrNames, out: IO[str]) -> None:
    """STAR SJ.out.tab 9-column format (what read_sj_group consumes)."""
    for i in range(sj.n):
        out.write(f"{cname[int(sj.tid[i])]}\t{int(sj.don[i])}\t{int(sj.acc[i])}\t"
                  f"{int(sj.strand[i])}\t{int(sj.motif[i])}\t{int(sj.is_anno[i])}\t"
                  f"{int(sj.uniq_c[i])}\t{int(sj.multi_c[i])}\t{int(sj.max_over[i])}\n")
