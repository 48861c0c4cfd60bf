"""SAM/BAM alignment-record interop.

The engine keeps alignments as dense tensors internally; this module is the
boundary format layer replacing htslib (reference htslib submodule usage
throughout src/).  It provides:

  * AlnRec — one alignment record (qname/flag/tid/pos/cigar/tags)
  * SAM text reading/writing
  * BAM reading/writing over BGZF (pure zlib framing; BAM spec layout)

CIGAR op codes follow the BAM encoding: M=0 I=1 D=2 N=3 S=4 H=5 P=6 ==7 X=8.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import IO, Iterator, List, Optional, Tuple

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)
_OP_IDX = {c: i for i, c in enumerate(CIGAR_OPS)}

# bit 0: consumes query; bit 1: consumes reference (BAM spec table)
_CONSUME = [3, 1, 2, 2, 1, 0, 0, 3, 3]
# reference BAM_CIGAR_QUERY_TYPE 0x3C5A7 (parse_bam.c:258): H consumes
# query — AlnRec.query_len() replicates that quirk for the fusion paths
_CONSUME_REF = [3, 1, 2, 2, 1, 1, 0, 3, 3]

FUNMAP = 0x4
FREVERSE = 0x10
FPROPER_PAIR = 0x2
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800

_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_OF = {c: i for i, c in enumerate(_SEQ_NT16)}
_NT16_BYTES = np.frombuffer(_SEQ_NT16.encode(), np.uint8)
_BASE_TO_NT16 = np.full(256, 15, np.uint8)
for _i, _c in enumerate(_SEQ_NT16):
    _BASE_TO_NT16[ord(_c)] = _i
    _BASE_TO_NT16[ord(_c.lower())] = _i


def parse_cigar(s: str) -> np.ndarray:
    """'10M2I5N...' -> int32 array of (len<<4 | op), BAM layout."""
    if s == "*":
        return np.zeros(0, np.uint32)
    out = []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((num << 4) | _OP_IDX[ch])
            num = 0
    return np.asarray(out, np.uint32)


def cigar_str(c: np.ndarray) -> str:
    if len(c) == 0:
        return "*"
    return "".join(f"{int(x) >> 4}{CIGAR_OPS[int(x) & 0xF]}" for x in c)


def cigar_qlen(c: np.ndarray) -> int:
    ops = c & 0xF
    lens = c >> 4
    return int(lens[(np.array(_CONSUME)[ops] & 1) > 0].sum())


def cigar_rlen(c: np.ndarray) -> int:
    ops = c & 0xF
    lens = c >> 4
    return int(lens[(np.array(_CONSUME)[ops] & 2) > 0].sum())


@dataclass
class AlnRec:
    qname: str = "*"
    flag: int = 0
    tid: int = -1
    pos: int = -1                 # 0-based leftmost
    mapq: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    mtid: int = -1
    mpos: int = -1
    isize: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: dict = field(default_factory=dict)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_rev(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_proper_pair(self) -> bool:
        return bool(self.flag & FPROPER_PAIR)

    @property
    def l_qseq(self) -> int:
        return 0 if self.seq == "*" else len(self.seq)

    def query_len(self) -> int:
        """CIGAR-consumed query length incl. BOTH clip kinds — faithful
        to reference bam_query_len (parse_bam.c:258-270, mask 0x3C5A7):
        hard clips consume query there, a deliberate quirk its fusion /
        bam2seg coordinate flips depend on.  `cigar_qlen` is the plain
        SAM-spec query length (H excluded)."""
        ops = self.cigar & 0xF
        lens = self.cigar >> 4
        return int(lens[(np.array(_CONSUME_REF)[ops] & 1) > 0].sum())

    def ref_len(self) -> int:
        return cigar_rlen(self.cigar)


class TagArray(list):
    """A SAM/BAM `B`-typed array tag value.  Subclasses list so existing
    consumers can index it; `sub` carries the element type char
    (c/C/s/S/i/I/f) so round-trips preserve the declared type."""

    def __init__(self, vals, sub: str = "i"):
        super().__init__(vals)
        self.sub = sub


class HexStr(str):
    """A SAM/BAM `H`-typed hex string (round-trips as H, not Z)."""


def _parse_tag_B(val: str) -> TagArray:
    sub = val[0]
    conv = float if sub == "f" else int
    items = val.split(",")[1:]
    return TagArray([conv(x) for x in items], sub)


_TAG_PARSERS = {
    "i": int, "A": str, "Z": str, "f": float, "H": HexStr,
    "B": _parse_tag_B,
}


def _parse_tag(f: str) -> Tuple[str, object]:
    name, typ, val = f.split(":", 2)
    p = _TAG_PARSERS.get(typ)
    return name, (p(val) if p else val)


class SamReader:
    """Streaming SAM text reader."""

    def __init__(self, fp: IO[str]):
        self.fp = fp
        self.header_lines: List[str] = []
        self.refs: List[Tuple[str, int]] = []
        self._pending: Optional[str] = None
        for line in fp:
            if line.startswith("@"):
                self.header_lines.append(line.rstrip("\n"))
                if line.startswith("@SQ"):
                    d = dict(x.split(":", 1) for x in line.rstrip("\n").split("\t")[1:])
                    self.refs.append((d["SN"], int(d["LN"])))
            else:
                self._pending = line
                break
        self._tid = {name: i for i, (name, _) in enumerate(self.refs)}

    def __iter__(self) -> Iterator[AlnRec]:
        line = self._pending
        self._pending = None
        while line:
            yield self._parse(line)
            line = self.fp.readline()

    def _parse(self, line: str) -> AlnRec:
        f = line.rstrip("\n").split("\t")
        rec = AlnRec(
            qname=f[0], flag=int(f[1]),
            tid=self._tid.get(f[2], -1), pos=int(f[3]) - 1,
            mapq=int(f[4]), cigar=parse_cigar(f[5]),
            mtid=(self._tid.get(f[6], -1) if f[6] != "=" else None),
            mpos=int(f[7]) - 1, isize=int(f[8]), seq=f[9], qual=f[10],
        )
        if rec.mtid is None:
            rec.mtid = rec.tid
        rec.tags = dict(_parse_tag(x) for x in f[11:])
        return rec


def _tag_sam(name: str, val) -> str:
    if isinstance(val, bool):
        return f"{name}:i:{int(val)}"
    if isinstance(val, int):
        return f"{name}:i:{val}"
    if isinstance(val, float):
        return f"{name}:f:{val}"
    if isinstance(val, HexStr):
        return f"{name}:H:{val}"
    if isinstance(val, (list, tuple)):
        sub = getattr(val, "sub", None) or (
            "f" if any(isinstance(x, float) for x in val) else "i")
        return f"{name}:B:{sub}," + ",".join(str(x) for x in val)
    if isinstance(val, str) and len(val) == 1:
        return f"{name}:A:{val}"
    return f"{name}:Z:{val}"


def sam_header(refs: List[Tuple[str, int]]) -> str:
    return ("@HD\tVN:1.6\tSO:unknown\n" +
            "".join(f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in refs))


class SamWriter:
    def __init__(self, fp: IO[str], refs: List[Tuple[str, int]],
                 header_lines: Optional[List[str]] = None):
        self.fp = fp
        self.refs = refs
        if header_lines:
            for h in header_lines:
                fp.write(h + "\n")
        else:
            fp.write(sam_header(refs))

    def write(self, r: AlnRec) -> None:
        rname = self.refs[r.tid][0] if r.tid >= 0 else "*"
        mr = "*" if r.mtid < 0 else ("=" if r.mtid == r.tid else self.refs[r.mtid][0])
        tags = "\t".join(_tag_sam(k, v) for k, v in r.tags.items())
        base = (f"{r.qname}\t{r.flag}\t{rname}\t{r.pos + 1}\t{r.mapq}\t"
                f"{cigar_str(r.cigar)}\t{mr}\t{r.mpos + 1}\t{r.isize}\t{r.seq}\t{r.qual}")
        self.fp.write(base + ("\t" + tags if tags else "") + "\n")


# --------------------------------------------------------------------- BGZF

_BGZF_HDR = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00")
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def bgzf_compress(data: bytes, level: int = 2) -> bytes:
    out = bytearray()
    for off in range(0, len(data), 0xFF00):
        chunk = data[off: off + 0xFF00]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        out += _BGZF_HDR + struct.pack("<H", bsize - 1) + cdata
        out += struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
    return bytes(out)


def bgzf_decompress(path: str) -> bytes:
    """Inflate an entire BGZF (or plain gzip) file."""
    from ..utils.fileio import read_bytes
    raw = read_bytes(path)
    out = bytearray()
    off = 0
    n = len(raw)
    while off < n:
        if raw[off: off + 2] != b"\x1f\x8b":
            raise ValueError("not a gzip/BGZF stream")
        # parse gzip member header to find XLEN/BSIZE
        flg = raw[off + 3]
        p = off + 10
        bsize = None
        if flg & 0x04:  # FEXTRA
            xlen = struct.unpack_from("<H", raw, p)[0]
            xend = p + 2 + xlen
            q = p + 2
            while q < xend:
                si1, si2, slen = raw[q], raw[q + 1], struct.unpack_from("<H", raw, q + 2)[0]
                if si1 == 66 and si2 == 67:
                    bsize = struct.unpack_from("<H", raw, q + 4)[0] + 1
                q += 4 + slen
            p = xend
        if bsize is not None:
            cdata = raw[off + (p - off): off + bsize - 8]
            out += zlib.decompress(cdata, -15)
            off += bsize
        else:  # plain gzip member: decompress the rest in one go
            d = zlib.decompressobj(31)
            out += d.decompress(raw[off:])
            if not d.eof:
                # truncated member: zlib hands back the partial inflate
                # silently — fail loudly instead of dropping the tail
                # (mirrors io/fasta._gunzip_to_array)
                raise EOFError(f"{path}: compressed stream ended before "
                               "the end-of-stream marker")
            off = n - len(d.unused_data)
            if d.unused_data == raw[off:] and not d.unused_data:
                break
    return bytes(out)


# ----------------------------------------------------------------- BAM codec

def _decode_tags(buf: bytes) -> dict:
    tags = {}
    p = 0
    n = len(buf)
    while p + 3 <= n:
        name = buf[p: p + 2].decode()
        typ = chr(buf[p + 2])
        p += 3
        if typ == "A":
            tags[name] = chr(buf[p]); p += 1
        elif typ in "cC":
            tags[name] = struct.unpack_from("<b" if typ == "c" else "<B", buf, p)[0]; p += 1
        elif typ in "sS":
            tags[name] = struct.unpack_from("<h" if typ == "s" else "<H", buf, p)[0]; p += 2
        elif typ in "iI":
            tags[name] = struct.unpack_from("<i" if typ == "i" else "<I", buf, p)[0]; p += 4
        elif typ == "f":
            tags[name] = struct.unpack_from("<f", buf, p)[0]; p += 4
        elif typ in "ZH":
            e = buf.index(b"\x00", p)
            s = buf[p:e].decode()
            tags[name] = HexStr(s) if typ == "H" else s
            p = e + 1
        elif typ == "B":
            sub = chr(buf[p]); cnt = struct.unpack_from("<i", buf, p + 1)[0]
            size = dict(c=1, C=1, s=2, S=2, i=4, I=4, f=4)[sub]
            fmt = "<" + str(cnt) + dict(c="b", C="B", s="h", S="H", i="i", I="I", f="f")[sub]
            tags[name] = TagArray(struct.unpack_from(fmt, buf, p + 5), sub)
            p += 5 + cnt * size
        else:
            break
    return tags


_B_PACK = dict(c="b", C="B", s="h", S="H", i="i", I="I", f="f")


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for name, val in tags.items():
        nb = name.encode()
        if isinstance(val, bool):
            out += nb + b"i" + struct.pack("<i", int(val))
        elif isinstance(val, int):
            out += nb + b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            out += nb + b"f" + struct.pack("<f", val)
        elif isinstance(val, HexStr):
            out += nb + b"H" + val.encode() + b"\x00"
        elif isinstance(val, (list, tuple)):
            sub = getattr(val, "sub", None) or (
                "f" if any(isinstance(x, float) for x in val) else "i")
            out += (nb + b"B" + sub.encode() +
                    struct.pack("<i", len(val)) +
                    struct.pack("<" + str(len(val)) + _B_PACK[sub], *val))
        elif isinstance(val, str) and len(val) == 1:
            out += nb + b"A" + val.encode()
        elif isinstance(val, str):
            out += nb + b"Z" + val.encode() + b"\x00"
    return bytes(out)


def read_bam(path: str) -> Tuple[List[Tuple[str, int]], List[str], Iterator[AlnRec]]:
    """Decode a whole BAM file. Returns (refs, header_lines, record iterator)."""
    data = bgzf_decompress(path)
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not BAM")
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = data[8: 8 + l_text].split(b"\x00")[0].decode()
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", data, p)[0]
    p += 4
    refs: List[Tuple[str, int]] = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, p)[0]
        name = data[p + 4: p + 4 + l_name - 1].decode()
        l_ref = struct.unpack_from("<i", data, p + 4 + l_name)[0]
        refs.append((name, l_ref))
        p += 8 + l_name

    def _iter(p=p):
        while p + 4 <= len(data):
            block = struct.unpack_from("<i", data, p)[0]
            q = p + 4
            (tid, pos, l_qname, mapq, _bin, n_cig, flag, l_seq, mtid, mpos,
             isize) = struct.unpack_from("<iiBBHHHiiii", data, q)
            q += 32
            qname = data[q: q + l_qname - 1].decode()
            q += l_qname
            cig = np.frombuffer(data, np.uint32, n_cig, q).copy()
            q += 4 * n_cig
            nb = (l_seq + 1) // 2
            seqbuf = np.frombuffer(data, np.uint8, nb, q)
            q += nb
            if l_seq:
                codes = np.empty(2 * nb, np.uint8)
                codes[0::2] = seqbuf >> 4
                codes[1::2] = seqbuf & 0xF
                seq = _NT16_BYTES[codes[:l_seq]].tobytes().decode()
            else:
                seq = "*"
            qual = data[q: q + l_seq]
            q += l_seq
            qstr = ("*" if not l_seq or qual[0] == 0xFF
                    else "".join(chr(c + 33) for c in qual))
            tags = _decode_tags(data[q: p + 4 + block])
            if ("CG" in tags and len(cig) == 2
                    and (cig[0] & 0xF) == OP_S and (cig[1] & 0xF) == OP_N):
                # spec long-CIGAR workaround: kSmN placeholder, real
                # CIGAR in CG:B,I (see encode_bam_rec)
                cig = np.asarray(tags.pop("CG"), np.uint32)
            yield AlnRec(qname, flag, tid, pos, mapq, cig, mtid, mpos, isize,
                         seq, qstr, tags)
            p += 4 + block

    header_lines = [l for l in text.split("\n") if l]
    return refs, header_lines, _iter()


def encode_bam_rec(r: AlnRec) -> bytes:
    qname = r.qname.encode() + b"\x00"
    l_seq = 0 if r.seq == "*" else len(r.seq)
    if l_seq:
        codes = _BASE_TO_NT16[np.frombuffer(r.seq.encode(), np.uint8)]
        if l_seq % 2:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        seqbuf = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    else:
        seqbuf = b""
    qual = (bytes([0xFF] * l_seq) if r.qual == "*" else
            bytes((ord(c) - 33) & 0xFF for c in r.qual[:l_seq]))
    if len(qname) > 255:
        raise ValueError(
            f"BAM l_read_name is a uint8: qname {r.qname[:40]!r}... is "
            f"{len(qname) - 1} bytes (max 254)")
    cigar = r.cigar
    rec_tags = r.tags
    if len(cigar) > 0xFFFF:
        # BAM n_cigar_op is a uint16: spec workaround moves the real
        # CIGAR to a CG:B,I tag behind a kSmN placeholder (htslib does
        # the same for ultra-long reads)
        rec_tags = dict(rec_tags)
        rec_tags["CG"] = TagArray([int(x) for x in cigar], "I")
        cigar = np.array([(cigar_qlen(r.cigar) << 4) | OP_S,
                          (cigar_rlen(r.cigar) << 4) | OP_N], np.uint32)
    tags = _encode_tags(rec_tags)
    body = struct.pack("<iiBBHHHiiii", r.tid, r.pos, len(qname), r.mapq,
                       4680, len(cigar), r.flag, l_seq, r.mtid, r.mpos,
                       r.isize)
    body += qname + cigar.astype("<u4").tobytes() + seqbuf + qual + tags
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, refs: List[Tuple[str, int]], header_lines: List[str],
              records) -> int:
    """Write records to a BAM file; returns the record count."""
    text = ("\n".join(header_lines) + "\n") if header_lines else ""
    hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
    hdr += struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    out = bytearray(hdr)
    cnt = 0
    for r in records:
        out += encode_bam_rec(r)
        cnt += 1
    with open(path, "wb") as f:
        f.write(bgzf_compress(bytes(out)))
        f.write(_BGZF_EOF)
    return cnt


def open_alignments(path: str):
    """Open SAM or BAM (sniffed) -> (refs, header_lines, iterator)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] == b"\x1f\x8b":
        return read_bam(path)
    fp = open(path)
    rd = SamReader(fp)
    return rd.refs, rd.header_lines, iter(rd)
