"""FASTA/FASTQ ingestion → packed numeric sequence buffers.

Replaces the role of vendored kseq.h + kseq_load_genome (reference
parse_bam.c:382-400) with a vectorized reader: sequences are stored as a
single concatenated uint8 code array (A=0,C=1,G=2,T=3, other=4) plus offset
tables, ready to feed the minimizer/alignment kernels.  Gzip input is
supported transparently (reference README.md:161-163).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils import log

# byte → 2-bit code lookup (A=0 C=1 G=2 T=3, anything else 4)
_CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _CODE[_b] = _i

_COMP = np.array([3, 2, 1, 0, 4], np.uint8)  # A<->T, C<->G, N->N

CODE_TO_BASE = np.frombuffer(b"ACGTN", np.uint8)


def encode_seq(seq: bytes) -> np.ndarray:
    return _CODE[np.frombuffer(seq, np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    return CODE_TO_BASE[codes].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[::-1]]


def _open(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fastx(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, seq-bytes) for FASTA or FASTQ, plain or gzipped."""
    with _open(path) as fp:
        first = fp.read(1)
        if not first:
            return
        if first == b">":  # FASTA
            # the '>' is consumed; the rest of the line is the header
            name = fp.readline().split()[0].decode()
            chunks: List[bytes] = []
            for raw in fp:
                if raw.startswith(b">"):
                    yield name, b"".join(chunks)
                    name = raw[1:].split()[0].decode()
                    chunks = []
                else:
                    chunks.append(raw.strip())
            yield name, b"".join(chunks)
        elif first == b"@":  # FASTQ (incl. legacy wrapped seq/qual lines)
            while True:
                name_line = fp.readline()
                if not name_line or not name_line.strip():
                    break
                name = name_line.split()[0].decode()
                # sequence: lines until the '+' separator
                seq_parts = []
                line = fp.readline()
                while line and not line.startswith(b"+"):
                    seq_parts.append(line.strip())
                    line = fp.readline()
                seq = b"".join(seq_parts)
                # quality: lines until the accumulated length covers the
                # sequence (a wrapped qual line may itself start with '@')
                ql = 0
                while ql < len(seq):
                    line = fp.readline()
                    if not line:
                        break
                    ql += len(line.strip())
                yield name, seq
                # skip stray blank separator lines between records — the
                # old `break` silently dropped every subsequent record
                nxt = fp.read(1)
                while nxt in (b"\n", b"\r"):
                    nxt = fp.read(1)
                if nxt != b"@":
                    if nxt:
                        raise ValueError(
                            "malformed FASTQ: expected '@' at record "
                            f"start, got {nxt!r}")
                    break
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


@dataclass
class SeqSet:
    """A set of named sequences in one flat code buffer."""

    names: List[str]
    codes: np.ndarray      # uint8 [total]
    offsets: np.ndarray    # int64 [n+1]

    @property
    def n(self) -> int:
        return len(self.names)

    def lengths(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)

    def get(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]: self.offsets[i + 1]]

    def __len__(self) -> int:
        return len(self.names)


class Genome(SeqSet):
    """Reference genome with O(1) slice access by (tid, 1-based start/end)."""

    @classmethod
    def load(cls, path: str) -> "Genome":
        """Delegates to read_fasta: one parser carries the CRLF guard,
        the gzip fast path and the native/vec dispatch for genomes and
        read sets alike (a hand-rolled copy here once diverged — CRLF
        genomes corrupted on the no-native path)."""
        log("load_genome", "loading genome fasta file ...")
        s = read_fasta(path)
        g = cls(s.names, s.codes, s.offsets)
        log("load_genome", "loading genome fasta file done!")
        return g

    def slice(self, tid: int, start: int, end: int) -> np.ndarray:
        """1-based inclusive [start, end] on chrom `tid` (clamped)."""
        o = self.offsets[tid]
        L = self.offsets[tid + 1] - o
        s = max(0, start - 1)
        e = min(int(L), end)
        return self.codes[o + s: o + e]


def _gather_names(buf: np.ndarray, name_off: np.ndarray,
                  name_len: np.ndarray) -> list:
    """Record names via ONE vectorized gather + ONE decode.

    A per-record `buf[o:o+l].tobytes().decode()` loop costs ~20 s at
    500k records on this host; gathering every name byte into one
    newline-separated buffer and splitting the single decoded string is
    ~1 s.  Names never contain whitespace (the parser cuts at the first
    space/tab/newline), so '\\n' is a safe separator."""
    nr = len(name_off)
    if nr == 0:
        return []
    if not isinstance(buf, np.ndarray):
        buf = np.frombuffer(buf, np.uint8)
    lens = name_len.astype(np.int64)
    tot = int(lens.sum())
    out_start = np.zeros(nr + 1, np.int64)
    np.cumsum(lens + 1, out=out_start[1:])          # +1 separator slot
    out = np.full(int(out_start[-1]), 10, np.uint8)
    inner = np.arange(tot, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(lens[:-1])]), lens)
    out[np.repeat(out_start[:-1], lens) + inner] = \
        buf[np.repeat(name_off, lens) + inner]
    return out.tobytes().decode()[:-1].split("\n")


def _parse_fasta_native(buf: bytes) -> Optional[SeqSet]:
    """One-pass native FASTA parse (csrc fasta_parse_c); None when the
    native lib is unavailable.  numpy elementwise ops run at an erratic
    ~70-150 MB/s on this host, so the C scan wins ~10x over both the
    line-loop and the vectorized parse."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    from ..utils.fileio import count_byte
    n = len(buf)
    cap_rec = max(count_byte(buf, ord(">")), 1)
    codes = np.empty(n, np.uint8)
    rec_off = np.empty(cap_rec + 1, np.int64)
    name_off = np.empty(cap_rec, np.int64)
    name_len = np.empty(cap_rec, np.int32)
    total = ctypes.c_int64()
    nr = int(lib.fasta_parse_c(buf, n, codes, rec_off, name_off, name_len,
                               ctypes.byref(total)))
    names = _gather_names(buf, name_off[:nr], name_len[:nr])
    # views, not copies: a fresh copy of an N-byte buffer pays the
    # ~150 MB/s first-touch cost again
    return SeqSet(names, codes[: int(total.value)],
                  rec_off[: nr + 1])


def _parse_fasta_vec(buf: bytes) -> SeqSet:
    """Vectorized plain-FASTA parse (numpy fallback for the native scan)."""
    a = np.frombuffer(buf, np.uint8)
    if len(a) and buf[-1:] != b"\n":
        a = np.concatenate([a, np.frombuffer(b"\n", np.uint8)])
    nl = _newline_positions(a)   # chunked (GB-scale one-shot compare trap)
    starts = np.empty(len(nl), np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    is_hdr = a[starts] == ord(">")
    hdr_idx = np.where(is_hdr)[0]
    names = []
    for li in hdr_idx.tolist():
        line = buf[starts[li] + 1: nl[li]]
        sp = line.find(b" ")
        tb = line.find(b"\t")
        cut = min(x for x in (sp, tb, len(line)) if x >= 0)
        names.append(line[:cut].decode())
    # per-record content length: record lines are contiguous, so reduceat
    # at the header line indices sums each record's sequence-line lengths
    line_len = nl - starts                      # content length (no \n)
    seq_len_per_line = np.where(is_hdr, 0, line_len)
    offs = np.zeros(len(hdr_idx) + 1, np.int64)
    np.cumsum(np.add.reduceat(seq_len_per_line, hdr_idx), out=offs[1:])
    # sequence-content mask: drop newlines + header-line characters
    keep = np.ones(len(a), bool)
    keep[nl] = False
    hl = line_len[hdr_idx]
    if hl.sum():
        flat = np.repeat(starts[hdr_idx], hl) + (
            np.arange(int(hl.sum())) -
            np.repeat(np.concatenate([[0], np.cumsum(hl[:-1])]), hl))
        keep[flat] = False
    codes = _CODE[a[keep]]
    return SeqSet(names, codes, offs)


def _newline_positions(buf: np.ndarray) -> np.ndarray:
    """Chunked np.flatnonzero(buf == 10) — the one-shot compare over a
    GB-scale buffer hits this image's pathological large-elementwise path
    (see utils/fileio.count_byte)."""
    CH = 1 << 24
    parts = [np.flatnonzero(buf[off: off + CH] == 10) + off
             for off in range(0, len(buf), CH)]
    if not parts:
        return np.zeros(0, np.int64)
    return np.concatenate(parts).astype(np.int64, copy=False)


def _parse_fastq_vec(buf: np.ndarray) -> Optional[SeqSet]:
    """Vectorized 4-line-record FASTQ parse; None for the (legacy)
    multiline layout, which falls back to the line loop."""
    if len(buf) == 0:
        return SeqSet([], np.zeros(0, np.uint8), np.zeros(1, np.int64))
    nl = _newline_positions(buf)
    if len(buf) and (not len(nl) or nl[-1] != len(buf) - 1):
        nl = np.concatenate([nl, [len(buf)]])   # virtual trailing newline
    if len(nl) % 4:
        return None
    starts = np.empty(len(nl), np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    hdr, seq_s, plus = starts[0::4], starts[1::4], starts[2::4]
    if not (buf[hdr] == ord("@")).all() or not (buf[plus] == ord("+")).all():
        return None
    seq_e = nl[1::4]
    # qual length must equal seq length (guards against multiline records
    # that happen to hit the '@'/'+' checks)
    if not ((nl[3::4] - starts[3::4]) == (seq_e - seq_s)).all():
        return None
    lens = seq_e - seq_s
    offs = np.zeros(len(hdr) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    tot = int(offs[-1])
    inner = np.arange(tot, dtype=np.int64) - np.repeat(offs[:-1], lens)
    codes = _CODE[buf[np.repeat(seq_s, lens) + inner]]
    # header lines (minus '@') in one decode; cut at first whitespace
    full = _gather_names(buf, hdr + 1, (nl[0::4] - hdr - 1).astype(np.int64))
    names = [h.split(None, 1)[0] if (" " in h or "\t" in h) else h
             for h in full]
    return SeqSet(names, codes, offs)


def _gunzip_to_array(path: str) -> np.ndarray:
    """Whole gzip member chain decompressed to one uint8 array (zlib's C
    inflate at ~200 MB/s — the gzip.open line loop is >10x slower)."""
    import zlib
    from ..utils.fileio import read_bytes
    raw = read_bytes(path)
    chunks = []
    d = None
    while raw:
        d = zlib.decompressobj(31)
        chunks.append(d.decompress(raw))
        raw = d.unused_data       # concatenated gzip members (bgzip etc.)
    if d is not None and not d.eof:
        # truncated member: zlib returns the partial output silently, and
        # any prefix of a FASTA is valid FASTA — fail loudly instead of
        # parsing a silently shortened dataset (gzip.open raised here too)
        raise EOFError(f"{path}: compressed file ended before the "
                       "end-of-stream marker")
    joined = b"".join(chunks) if len(chunks) != 1 else chunks[0]
    return np.frombuffer(joined, np.uint8)


def read_fasta(path: str) -> SeqSet:
    """FASTA or FASTQ, plain or gzipped — vectorized/native parse on
    every path; the iter_fastx line loop remains only as the fallback
    for legacy multiline FASTQ."""
    with open(path, "rb") as f:
        head = f.read(2)
    buf = None
    if head[:2] == b"\x1f\x8b":
        buf = _gunzip_to_array(path)
    elif head[:1] in (b">", b"@"):
        from ..utils.fileio import read_into_array
        buf = read_into_array(path)
    if buf is not None and len(buf):
        from ..utils.fileio import count_byte
        if count_byte(buf, 13):
            buf = None      # CRLF input: the line loop strips '\r'; the
            #                 vectorized parsers would encode it as N
    if buf is not None and len(buf) and buf[0] == ord(">"):
        s = _parse_fasta_native(buf)
        return s if s is not None else _parse_fasta_vec(buf.tobytes())
    if buf is not None and len(buf) and buf[0] == ord("@"):
        s = _parse_fastq_vec(buf)
        if s is not None:
            return s
    elif buf is not None and len(buf) == 0:
        return SeqSet([], np.zeros(0, np.uint8), np.zeros(1, np.int64))
    names, bufs = [], []
    for name, seq in iter_fastx(path):
        names.append(name)
        bufs.append(encode_seq(seq))
    offs = np.zeros(len(bufs) + 1, np.int64)
    if bufs:
        np.cumsum([len(b) for b in bufs], out=offs[1:])
    return SeqSet(names, np.concatenate(bufs) if bufs else np.zeros(0, np.uint8), offs)


read_fastq_or_fasta = read_fasta
