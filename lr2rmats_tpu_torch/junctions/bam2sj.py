"""Splice-junction extraction from aligned short reads (`bam2sj`).

Reference: bam2sj_core / gen_sj / intr_deri_str / sj_update_group
(parse_bam.c:896-924, 402-442, 319-337, 353-380).

Junction motif ids: 0 non-canonical, 1 GT/AG, 2 CT/AC, 3 GC/AG, 4 CT/GC,
5 AT/AC, 6 GT/AT; strand 1 for the forward motifs, 2 for their reverse
complements, 0 if conflicting/unknown.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..io.fasta import Genome
from ..io.sam import AlnRec, OP_EQ, OP_D, OP_M, OP_N, OP_X
from ..io.sj import SJTable
from ..transcript.model import INTRON_MIN_LEN
from ..utils import log

# motif table (reference parse_bam.c:18-25): pairs of donor+acceptor
# dinucleotide codes; A=0 C=1 G=2 T=3
_MOTIFS = [
    (2, 3, 0, 2),  # GTAG  -> strand 1
    (1, 3, 0, 1),  # CTAC  -> strand 2
    (2, 1, 0, 2),  # GCAG  -> strand 1
    (1, 3, 2, 1),  # CTGC  -> strand 2
    (0, 3, 0, 1),  # ATAC  -> strand 1
    (2, 3, 0, 3),  # GTAT  -> strand 2
]
_MOTIF_STRAND = [1, 2, 1, 2, 1, 2]


def intron_motif_of(genome: Optional[Genome], tid: int, start: int, end: int) -> Tuple[int, int]:
    """(strand, motif_id) of intron [start, end] (1-based, inclusive)
    (reference intr_deri_str, parse_bam.c:319-337)."""
    if genome is None:
        return 0, 0
    codes = genome.get(tid)
    i0, i1 = start - 1, start
    j0, j1 = end - 2, end - 1
    if i0 < 0 or j1 >= len(codes):
        return 0, 0
    quad = (int(codes[i0]), int(codes[i1]), int(codes[j0]), int(codes[j1]))
    for m, motif in enumerate(_MOTIFS):
        if quad == motif:
            return _MOTIF_STRAND[m], m + 1
    return 0, 0


def rec_junctions(rec: AlnRec, min_intron: int):
    """Yield (don, acc) introns from N ops >= min_intron
    (reference gen_sj, parse_bam.c:402-442)."""
    end = rec.pos  # 1-based end so far = pos (0-based) since end=start-1
    for c in rec.cigar:
        op = int(c) & 0xF
        l = int(c) >> 4
        if op == OP_N:
            if l >= min_intron:
                yield end + 1, end + l
            end += l
        elif op in (OP_M, OP_EQ, OP_X, OP_D):
            end += l
        # I/S/H/P consume no reference


def is_uniq_nh(rec: AlnRec) -> bool:
    """NH tag == 1 (reference bam_is_uniq_NH, parse_bam.c:240-248; missing
    NH counts as non-unique)."""
    nh = rec.tags.get("NH")
    if nh is None:
        return False
    return int(nh) == 1


def bam2sj_records(records: Iterable[AlnRec], genome: Optional[Genome],
                   min_intron: int = INTRON_MIN_LEN,
                   require_proper_pair: bool = True,
                   use_multi: bool = True) -> SJTable:
    """Accumulate the SJ table from an alignment stream
    (reference bam2sj_core, parse_bam.c:896-924).

    Reference semantics: unmapped and (for paired data) non-proper-pair
    records are skipped; uniq vs multi decided by NH; counts accumulated per
    distinct (tid, don, acc); conflicting strands -> 0.
    """
    log("bam2sj", "generating splice-junction with BAM file ...")
    acc_map: Dict[Tuple[int, int, int], list] = {}
    for rec in records:
        if rec.is_unmapped:
            continue
        uniq = is_uniq_nh(rec)
        if not use_multi and not uniq:
            continue
        if require_proper_pair and not rec.is_proper_pair:
            continue
        for don, acc in rec_junctions(rec, min_intron):
            strand, motif = intron_motif_of(genome, rec.tid, don, acc)
            key = (rec.tid, don, acc)
            ent = acc_map.get(key)
            if ent is None:
                acc_map[key] = [strand, motif, 1, int(uniq), int(not uniq)]
            else:
                ent[3] += int(uniq)
                ent[4] += int(not uniq)
                if ent[0] != strand:
                    ent[0] = 0
    keys = sorted(acc_map)
    n = len(keys)
    t = SJTable(
        tid=np.array([k[0] for k in keys], np.int32),
        don=np.array([k[1] for k in keys], np.int32),
        acc=np.array([k[2] for k in keys], np.int32),
        strand=np.array([acc_map[k][0] for k in keys], np.int8),
        motif=np.array([acc_map[k][1] for k in keys], np.int8),
        is_anno=np.array([acc_map[k][2] for k in keys], np.int8),
        uniq_c=np.array([acc_map[k][3] for k in keys], np.int32),
        multi_c=np.array([acc_map[k][4] for k in keys], np.int32),
        max_over=np.zeros(n, np.int32),
    )
    log("bam2sj", "generating splice-junction with BAM file done!")
    return t
