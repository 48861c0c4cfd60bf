"""Packed struct-of-arrays alignment records.

The per-record AlnRec path costs ~70 us/record to build plus ~25 us to
format (measured); at 500k reads that is minutes of pure python object
churn.  RecordBatch keeps the whole batch as flat arrays — ragged CIGARs
and sequences live in shared buffers with offset tables, and sequences are
stored ONCE per read as forward-strand codes with a per-record
reverse-complement flag (secondary alignments share the primary's bytes).

SAM text emission is one native call (csrc format_sam_batch_c) with a
python fallback; AlnRec materialization is kept for the legacy API
(`to_alnrecs`) and is the compatibility bridge for code that still wants
objects (reference role: the SAM emit loop of minimap2's worker threads).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.fasta import decode_seq, encode_seq, revcomp
from ..io.sam import AlnRec, FREVERSE, cigar_str


@dataclass
class RecordBatch:
    qname: List[str]
    flag: np.ndarray        # int32 [n]
    tid: np.ndarray         # int32 [n]
    pos: np.ndarray         # int64 [n] 0-based chrom-local
    mapq: np.ndarray        # int32 [n]
    cig_buf: np.ndarray     # uint32 ragged CIGAR codes ((len<<4)|op)
    cig_offs: np.ndarray    # int64 [n+1]
    seq_buf: np.ndarray     # uint8 forward-strand codes, ragged per SEQ id
    seq_offs: np.ndarray    # int64 [n_seqs+1]
    seq_id: np.ndarray      # int32 [n] -> sequence slot
    seq_rc: np.ndarray      # int8 [n] 1 => record is on the reverse strand
    nm: np.ndarray          # int64 [n] edit distance (NM tag)
    score: np.ndarray       # int64 [n] AS tag
    nh: np.ndarray          # int32 [n] NH tag
    xs: np.ndarray          # int8 [n] 0 = no XS tag, +1 = '+', -1 = '-'

    @property
    def n(self) -> int:
        return len(self.flag)

    def cigar(self, i: int) -> np.ndarray:
        return self.cig_buf[self.cig_offs[i]: self.cig_offs[i + 1]]

    def set_cigar(self, i: int, cig: np.ndarray) -> None:
        """Replace record i's CIGAR (ragged surgery; O(total) worst case,
        only used by the low-volume polish patch path)."""
        old = self.cig_offs[i + 1] - self.cig_offs[i]
        delta = len(cig) - old
        if delta == 0:
            self.cig_buf[self.cig_offs[i]: self.cig_offs[i + 1]] = cig
            return
        self.cig_buf = np.concatenate([
            self.cig_buf[: self.cig_offs[i]], np.asarray(cig, np.uint32),
            self.cig_buf[self.cig_offs[i + 1]:]])
        self.cig_offs = self.cig_offs.copy()
        self.cig_offs[i + 1:] += delta

    def seq_codes(self, i: int) -> np.ndarray:
        """As-aligned codes (reverse-complemented when seq_rc[i])."""
        s = self.seq_buf[self.seq_offs[self.seq_id[i]]:
                         self.seq_offs[self.seq_id[i] + 1]]
        return revcomp(s) if self.seq_rc[i] else s

    # ------------------------------------------------------------ interop
    def to_alnrecs(self) -> List[AlnRec]:
        out = []
        for i in range(self.n):
            tags = {"NM": int(self.nm[i]), "AS": int(self.score[i]),
                    "NH": int(self.nh[i])}
            if self.xs[i]:
                tags["XS"] = "+" if self.xs[i] > 0 else "-"
            out.append(AlnRec(
                qname=self.qname[i], flag=int(self.flag[i]),
                tid=int(self.tid[i]), pos=int(self.pos[i]),
                mapq=int(self.mapq[i]), cigar=self.cigar(i).copy(),
                seq=decode_seq(self.seq_codes(i)), qual="*", tags=tags))
        return out

    @classmethod
    def from_alnrecs(cls, recs: Sequence[AlnRec]) -> "RecordBatch":
        """Legacy bridge: each record gets its own sequence slot, stored
        as-aligned with seq_rc=0 (emission output is identical)."""
        n = len(recs)
        qname = [r.qname for r in recs]
        flag = np.array([r.flag for r in recs], np.int32)
        tid = np.array([r.tid for r in recs], np.int32)
        pos = np.array([r.pos for r in recs], np.int64)
        mapq = np.array([r.mapq for r in recs], np.int32)
        cig_offs = np.zeros(n + 1, np.int64)
        np.cumsum([len(r.cigar) for r in recs], out=cig_offs[1:])
        cig_buf = (np.concatenate([r.cigar for r in recs]).astype(np.uint32)
                   if n else np.zeros(0, np.uint32))
        seqs = [encode_seq(r.seq.encode()) if r.seq != "*"
                else np.zeros(0, np.uint8) for r in recs]
        seq_offs = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=seq_offs[1:])
        seq_buf = (np.concatenate(seqs).astype(np.uint8) if n
                   else np.zeros(0, np.uint8))
        nm = np.array([int(r.tags.get("NM", 0)) for r in recs], np.int64)
        score = np.array([int(r.tags.get("AS", 0)) for r in recs], np.int64)
        nh = np.array([int(r.tags.get("NH", 1)) for r in recs], np.int32)
        xs = np.array([{"+": 1, "-": -1}.get(r.tags.get("XS"), 0)
                       for r in recs], np.int8)
        return cls(qname, flag, tid, pos, mapq, cig_buf, cig_offs,
                   seq_buf, seq_offs, np.arange(n, dtype=np.int32),
                   np.zeros(n, np.int8), nm, score, nh, xs)

    @classmethod
    def concat(cls, batches: Sequence["RecordBatch"]) -> "RecordBatch":
        if len(batches) == 1:
            return batches[0]
        if not batches:
            return cls.from_alnrecs([])
        qname: List[str] = []
        for b in batches:
            qname.extend(b.qname)
        seq_base = np.cumsum([0] + [len(b.seq_offs) - 1 for b in batches])
        seq_id = np.concatenate([b.seq_id + seq_base[i]
                                 for i, b in enumerate(batches)])
        def _ragged(offs_name, buf_name):
            bufs = [getattr(b, buf_name) for b in batches]
            lens = [np.diff(getattr(b, offs_name)) for b in batches]
            all_lens = np.concatenate(lens) if lens else np.zeros(0, np.int64)
            offs = np.zeros(len(all_lens) + 1, np.int64)
            np.cumsum(all_lens, out=offs[1:])
            return np.concatenate(bufs), offs
        cig_buf, cig_offs = _ragged("cig_offs", "cig_buf")
        seq_buf, seq_offs = _ragged("seq_offs", "seq_buf")
        cat = lambda f: np.concatenate([getattr(b, f) for b in batches])
        return cls(qname, cat("flag"), cat("tid"), cat("pos"), cat("mapq"),
                   cig_buf, cig_offs, seq_buf, seq_offs,
                   seq_id.astype(np.int32), cat("seq_rc"), cat("nm"),
                   cat("score"), cat("nh"), cat("xs"))

    # ------------------------------------------------------------ SAM emit
    def emit_sam(self, refs: List[Tuple[str, int]]) -> bytes:
        """All records as SAM text body bytes (no header)."""
        out = self.emit_sam_array(refs)
        return out.tobytes() if isinstance(out, np.ndarray) else out

    def emit_sam_array(self, refs: List[Tuple[str, int]]):
        """SAM body as a uint8 array view — the zero-copy variant the
        pipeline uses (a .tobytes() of a ~900 MB body costs seconds on
        this host's first-touch-slow VM).  One native call when the
        library is available, byte-identical fallback."""
        from ..native import get_lib
        lib = get_lib()
        if lib is None or not self.n:
            return np.frombuffer(self._emit_sam_py(refs), np.uint8)
        qname_blob = "\x00".join(self.qname).encode() + b"\x00"
        qname_offs = np.zeros(self.n + 1, np.int64)
        np.cumsum([len(q.encode()) + 1 for q in self.qname],
                  out=qname_offs[1:])
        ref_blob = "\x00".join(r[0] for r in refs).encode() + b"\x00"
        ref_offs = np.zeros(len(refs) + 1, np.int64)
        np.cumsum([len(r[0].encode()) + 1 for r in refs], out=ref_offs[1:])
        seq_lens = np.diff(self.seq_offs)
        cap = int(qname_offs[-1] + seq_lens[self.seq_id].sum() +
                  12 * len(self.cig_buf) + 160 * self.n + 1024)
        out = np.empty(cap, np.uint8)
        nw = lib.format_sam_batch_c(
            np.frombuffer(qname_blob, np.uint8), qname_offs,
            np.ascontiguousarray(self.flag, np.int32),
            np.ascontiguousarray(self.tid, np.int32),
            np.ascontiguousarray(self.pos, np.int64),
            np.ascontiguousarray(self.mapq, np.int32),
            np.ascontiguousarray(self.cig_buf, np.uint32),
            np.ascontiguousarray(self.cig_offs, np.int64),
            np.ascontiguousarray(self.seq_buf, np.uint8),
            np.ascontiguousarray(self.seq_offs, np.int64),
            np.ascontiguousarray(self.seq_id, np.int32),
            np.ascontiguousarray(self.seq_rc, np.int8),
            np.ascontiguousarray(self.nm, np.int64),
            np.ascontiguousarray(self.score, np.int64),
            np.ascontiguousarray(self.nh, np.int32),
            np.ascontiguousarray(self.xs, np.int8),
            np.frombuffer(ref_blob, np.uint8), ref_offs,
            self.n, out, cap)
        if nw < 0:
            return np.frombuffer(self._emit_sam_py(refs), np.uint8)
        return out[:nw]

    def _emit_sam_py(self, refs) -> bytes:
        lines = []
        for i in range(self.n):
            rname = refs[self.tid[i]][0] if self.tid[i] >= 0 else "*"
            tags = f"NM:i:{self.nm[i]}\tAS:i:{self.score[i]}\tNH:i:{self.nh[i]}"
            if self.xs[i]:
                tags += "\tXS:A:" + ("+" if self.xs[i] > 0 else "-")
            lines.append(
                f"{self.qname[i]}\t{self.flag[i]}\t{rname}\t{self.pos[i] + 1}"
                f"\t{self.mapq[i]}\t{cigar_str(self.cigar(i))}\t*\t0\t0\t"
                f"{decode_seq(self.seq_codes(i)) or '*'}\t*\t{tags}\n")
        return "".join(lines).encode()
