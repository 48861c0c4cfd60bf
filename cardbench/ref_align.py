"""The plain reference that judges served long-read alignments.

It imports nothing of the program.  It reads the SAM text a timed call
produced, the reads and the planted truth that the harness generated, and
the genome; it works everything else out again.

Four numbers, over the reads of the judged calls:

  * `bad_records`: primary records that do not describe an alignment of
    their read.  A primary's CIGAR must walk the read exactly (M + I + S =
    read length) inside its chromosome, and its SEQ must be the read
    (reverse-complemented on the reverse strand).  A read with two
    primaries counts as one bad record.  Exact: the limit is 0.  The NM and
    AS tags are not held to the CIGAR: the program's terminal-exon rescue
    leaves them unequal to the recomputed values on a few records of a
    run, so the reference scores each record itself.
  * `misplaced_pct`: the share of reads that are not placed on their own
    gene: no primary, a primary on another chromosome or off the planted
    gene's span, or one that aligns (M) fewer than half of the read's
    bases.  This is where a chain that is lost or wrong shows.
  * `introns_missed_pct`: the share of the planted introns of the reads
    that the read's primary does not report exactly, as an N op from the
    intron's first base to its last, or at a placement that splices the
    same transcript (`same_splice`: the intron moved by d bases where the
    d bases it moves over read the same at both of its ends; no read can
    tell the two apart).  This is where a junction placed wrong, by
    extension or by polish, shows.
    Both leave out the reads of genes with an exon in a pasted repeat
    copy (gen.Deployment.repeated): they have a second true place.
  * `score_deficit_pct`, over a sample of the reads: how far the served
    alignments fall below the best alignment of each read to its own
    planted transcript.  The reference best T is a local alignment
    (Smith-Waterman, +2 a match, -4 a mismatch and -4 a gap base, the
    aligner's score; introns free because the transcript is spliced) of
    the read, in transcript orientation, against the transcript.  The
    served score S is the AS that the reference recomputes from the read's
    primary, the read and the genome (2 * matching bases - 4 * NM, the
    aligner's own definition; 0 when the read has no primary).  The number
    is 100 * sum(max(0, T - S)) / sum(T): a read aligned as well as its
    truth allows adds nothing, a read left unaligned adds all of its T.

`sw_best` is the reference DP in int32.  `sw_align` runs the same DP in
any precision with a traceback and `control_sam` writes what it chose as
SAM records on the genome: the reference put in the program's place, which
`judge` judges as it judges the program (the control of `correct`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .gen import COMP, Deployment, Gene

MATCH, MISMATCH, GAP = 2, -4, -4
_CIGAR = re.compile(rb"(\d+)([MIDNS=X])")
_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i


@dataclass
class Judged:
    """One call's SAM text and what the harness knows of its reads: their
    names, the reads as generated, whether each is the reverse complement
    of its transcript, and each read's planted gene."""
    sam: bytes
    names: List[bytes]
    reads: List[np.ndarray]
    rc: np.ndarray
    genes: List[Gene]


def parse_primaries(sam: bytes) -> Tuple[Dict[bytes, list], int]:
    """qname -> [flag, rname, pos (1-based), cigar, seq] of each read's
    primary record, and the number of reads with more than one
    primary.  Unmapped and secondary or supplementary records are
    skipped."""
    out: Dict[bytes, list] = {}
    doubled = 0
    for line in sam.split(b"\n"):
        if not line or line[:1] == b"@":
            continue
        f = line.split(b"\t")
        flag = int(f[1])
        if flag & 0x904:
            continue
        rec = [flag, f[2], int(f[3]), f[5], f[9]]
        if f[0] in out:
            doubled += 1
        out[f[0]] = rec
    return out, doubled


@dataclass
class Walk:
    """What a primary record says, as the reference reads it."""
    ok: bool                        # walks its read inside the chromosome
    start: int                      # 0-based first reference base
    end: int                        # one past the last
    aligned: int                    # read bases under M / = / X
    introns: List[Tuple[int, int]]  # N ops, 0-based [first, last + 1)
    score: Optional[int] = None     # 2 * matches - 4 * NM, when asked


def walk(rec: list, read: np.ndarray, chrom: Dict[bytes, np.ndarray],
         score: bool = False) -> Walk:
    """Walk one primary record of `read` (the read as generated) over its
    chromosome."""
    flag, rname, pos, cigar, seq = rec
    g = chrom.get(rname)
    ops = _CIGAR.findall(cigar)
    bad = Walk(False, 0, 0, 0, [], 0 if score else None)
    if g is None or pos < 1 or b"".join(n + o for n, o in ops) != cigar:
        return bad
    aligned = COMP[read[::-1]] if flag & 16 else read
    ok = np.array_equal(_LUT[np.frombuffer(seq, np.uint8)], aligned)
    qi, gi, nm, matches, m_bases = 0, pos - 1, 0, 0, 0
    introns = []
    for n, op in ops:
        n = int(n)
        if op in b"M=X":
            if score:
                a = aligned[qi: qi + n]
                b = g[gi: gi + n]
                if len(a) != n or len(b) != n:
                    return bad
                e = int(np.count_nonzero(a != b))
                nm += e
                matches += n - e
            m_bases += n
            qi += n
            gi += n
        elif op == b"I":
            nm += n
            qi += n
        elif op == b"D":
            nm += n
            gi += n
        elif op == b"N":
            introns.append((gi, gi + n))
            gi += n
        else:                                       # S
            qi += n
    ok = ok and qi == len(read) and gi <= len(g)
    return Walk(ok, pos - 1, gi, m_bases, introns,
                2 * matches - 4 * nm if score else None)


def gene_introns(g: Gene) -> List[Tuple[int, int]]:
    """The planted introns of a gene, 0-based [first, last + 1)."""
    return [(b1, a2) for (_, b1), (a2, _) in zip(g.exons[:-1], g.exons[1:])]


def same_splice(g: np.ndarray, planted: Tuple[int, int],
                rep: Tuple[int, int]) -> bool:
    """Whether the reported intron `rep` splices the same transcript out of
    chromosome `g` as the planted intron does: the same length, moved by d
    bases over d bases that read the same at the intron's two ends."""
    (b1, a2), (s, e) = planted, rep
    d = s - b1
    if e - s != a2 - b1 or d == 0 or abs(d) > a2 - b1:
        return False
    if d > 0:
        return np.array_equal(g[b1: b1 + d], g[a2: a2 + d])
    return b1 + d >= 0 and np.array_equal(g[b1 + d: b1], g[a2 + d: a2])


def placed(w: Optional[Walk], rname: bytes, g: Gene, chrom_name: bytes,
           read_len: int) -> bool:
    """Whether a read's primary places it on its own gene."""
    return (w is not None and rname == chrom_name and
            w.start < g.exons[-1][1] and w.end > g.exons[0][0] and
            2 * w.aligned >= read_len)


def _blocks(reads: List[np.ndarray], block: int):
    order = np.argsort([len(r) for r in reads], kind="stable")
    for lo in range(0, len(order), block):
        yield order[lo: lo + block]


def _pad(seqs, idx, fill, device):
    L = max(len(seqs[i]) for i in idx)
    out = np.full((len(idx), L), fill, np.uint8)
    for k, i in enumerate(idx):
        out[k, : len(seqs[i])] = seqs[i]
    return torch.from_numpy(out).to(device)


def _rows(R, T, dtype):
    """Yield, for each read position i, (i, H_i, diag_i, up_i) of the local
    alignment DP with linear gaps in `dtype`; H_i[b, j] is the best score
    of an alignment of read b ending at read base i and transcript base j."""
    B, Lt = T.shape
    dev = T.device
    H = torch.zeros((B, Lt), dtype=dtype, device=dev)
    ramp = (torch.arange(Lt, device=dev) * -GAP).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    match = torch.tensor(MATCH, dtype=dtype, device=dev)
    mism = torch.tensor(MISMATCH, dtype=dtype, device=dev)
    for i in range(R.shape[1]):
        s = torch.where(T == R[:, i: i + 1], match, mism)
        diag = torch.nn.functional.pad(H[:, :-1], (1, 0)) + s
        up = H + GAP
        h = torch.maximum(torch.maximum(diag, up), zero)
        # left moves: H[j] = max_k (h[k] + GAP * (j - k))
        H = torch.cummax(h + ramp, dim=1).values - ramp
        yield i, H, diag, up


def sw_best(reads: List[np.ndarray], txs: List[np.ndarray], device,
            block: int = 1024) -> np.ndarray:
    """The best local alignment score of each read against its transcript,
    in int32 (exact)."""
    best = np.zeros(len(reads), np.int64)
    for idx in _blocks(reads, block):
        R = _pad(reads, idx, 4, device)
        T = _pad(txs, idx, 5, device)
        b = torch.zeros(len(idx), dtype=torch.int32, device=device)
        for _, H, _, _ in _rows(R, T, torch.int32):
            b = torch.maximum(b, H.max(dim=1).values)
        best[idx] = b.cpu().numpy()
    return best


_OPS = np.array([0, ord("M"), ord("I"), ord("D")], np.uint8)
_ALPHA = np.frombuffer(b"ACGTN", np.uint8)


def sw_align(reads: List[np.ndarray], txs: List[np.ndarray], device,
             dtype=torch.bfloat16, block: int = 256):
    """The reference's alignment of each read against its transcript with
    the DP, its choice of end cell and its moves made in `dtype`:
    (r0, r1, t0, t1, ops) a read, the aligned read and transcript ranges
    and the moves as [(op, length)] with op in b"MID".  In int32 it finds
    an alignment of sw_best's score."""
    out: list = [None] * len(reads)
    for idx in _blocks(reads, block):
        R = _pad(reads, idx, 4, device)
        T = _pad(txs, idx, 5, device)
        B, Lr = R.shape
        Lt = T.shape[1]
        dirs = torch.empty((Lr, B, Lt), dtype=torch.uint8, device=device)
        best = torch.full((B,), -1, dtype=dtype, device=device)
        bi = torch.zeros(B, dtype=torch.int64, device=device)
        bj = torch.zeros(B, dtype=torch.int64, device=device)
        for i, H, diag, up in _rows(R, T, dtype):
            d = torch.full_like(dirs[i], 3)
            d = torch.where(H == up, torch.full_like(d, 2), d)
            d = torch.where(H == diag, torch.full_like(d, 1), d)
            d = torch.where(H <= 0, torch.zeros_like(d), d)
            dirs[i] = d
            m, j = H.max(dim=1)
            better = m > best
            best = torch.where(better, m, best)
            bi = torch.where(better, torch.full_like(bi, i), bi)
            bj = torch.where(better, j, bj)
        ar = torch.arange(B, device=device)
        i, j = bi.clone(), bj.clone()
        alive = torch.ones(B, dtype=torch.bool, device=device)
        moves = torch.zeros((Lr + Lt, B), dtype=torch.uint8, device=device)
        for step in range(Lr + Lt):
            alive &= (i >= 0) & (j >= 0)
            if not bool(alive.any()):
                break
            d = dirs[i.clamp(min=0), ar, j.clamp(min=0)]
            alive &= d != 0
            moves[step] = torch.where(alive, d, torch.zeros_like(d))
            i = torch.where(alive & (d != 3), i - 1, i)
            j = torch.where(alive & (d != 2), j - 1, j)
        mv = moves.cpu().numpy()
        i, j, bi, bj = (t.cpu().numpy() for t in (i, j, bi, bj))
        for k, r in enumerate(idx):
            path = _OPS[mv[:, k][mv[:, k] != 0][::-1]]
            cut = np.flatnonzero(np.diff(path)) + 1
            runs = [(bytes(p[:1]), len(p)) for p in np.split(path, cut)
                    if len(p)]
            out[r] = (int(i[k]) + 1, int(bi[k]) + 1,
                      int(j[k]) + 1, int(bj[k]) + 1, runs)
    return out


def control_sam(names: List[bytes], reads: List[np.ndarray], rc: np.ndarray,
                genes: List[Gene], dep: Deployment, alns) -> bytes:
    """SAM records on the genome of sw_align's alignments (reads in
    transcript orientation): the transcript's exon boundaries become N ops
    of the planted introns, the unaligned ends soft clips.  A read with an
    empty alignment gets no record."""
    lines = []
    for name, read, flip, g, aln in zip(names, reads, rc, genes, alns):
        r0, r1, t0, t1, runs = aln
        if r1 <= r0:
            continue
        ex_len = np.array([b - a for a, b in g.exons], np.int64)
        bounds = np.cumsum(ex_len)[:-1]            # transcript positions
        introns = [a2 - b1 for b1, a2 in gene_introns(g)]
        e = int(np.searchsorted(bounds, t0, side="right"))
        pos = g.exons[e][0] + t0 - (int(bounds[e - 1]) if e else 0)
        cig = [(b"S", r0)] if r0 else []
        t = t0
        for op, n in runs:
            if op == b"I":
                cig.append((op, n))
                continue
            while n:
                if e < len(bounds) and t == bounds[e]:
                    cig.append((b"N", introns[e]))
                    e += 1
                step = n if e >= len(bounds) else min(n, int(bounds[e]) - t)
                cig.append((op, step))
                t += step
                n -= step
        if len(read) > r1:
            cig.append((b"S", len(read) - r1))
        merged: list = []
        for op, n in cig:
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + n)
            elif n:
                merged.append((op, n))
        seq = COMP[read[::-1]] if flip else read
        lines.append(b"\t".join([
            name, b"16" if flip else b"0", dep.names[g.chrom].encode(),
            str(pos + 1).encode(), b"60",
            b"".join(str(n).encode() + op for op, n in merged),
            b"*", b"0", b"0", _ALPHA[seq].tobytes(), b"*"]))
    return b"\n".join(lines) + b"\n"


def judge(calls: List[Judged], dep: Deployment,
          sample: List[Tuple[int, int]], device) -> dict:
    """The four numbers over the judged calls, with what they were computed
    from.  `sample` lists the (call, read) pairs whose score deficit is
    taken."""
    chrom = {n.encode(): dep.codes[dep.offsets[i]: dep.offsets[i + 1]]
             for i, n in enumerate(dep.names)}
    cnames = [n.encode() for n in dep.names]
    in_sample = set(sample)
    bad = misplaced = n_reads = n_introns = missed = repeated = moved = 0
    rep: Dict[int, bool] = {}
    S: Dict[Tuple[int, int], int] = {}
    for k, c in enumerate(calls):
        prim, doubled = parse_primaries(c.sam)
        bad += doubled
        for i, name in enumerate(c.names):
            read, g = c.reads[i], c.genes[i]
            rec = prim.get(name)
            w = None
            if rec is not None:
                w = walk(rec, read, chrom, score=(k, i) in in_sample)
                bad += not w.ok
            if rep.setdefault(id(g), dep.repeated(g)):
                repeated += 1
            else:
                n_reads += 1
                misplaced += not placed(w, rec[1] if rec else b"", g,
                                        cnames[g.chrom], len(read))
                want = gene_introns(g)
                n_introns += len(want)
                own = w is not None and rec[1] == cnames[g.chrom]
                got = set(w.introns) if own else set()
                for x in want:
                    if x in got:
                        continue
                    if any(same_splice(chrom[rec[1]], x, y)
                           for y in (w.introns if own else ())):
                        moved += 1
                    else:
                        missed += 1
            if (k, i) in in_sample:
                S[(k, i)] = w.score if w is not None else 0
    R_in, T_in = [], []
    for k, i in sample:
        c = calls[k]
        read = c.reads[i]
        R_in.append(COMP[read[::-1]] if c.rc[i] else read)
        T_in.append(dep.transcript(c.genes[i]))
    T = sw_best(R_in, T_in, device)
    Sv = np.array([S[x] for x in sample], np.int64)
    deficit = np.maximum(T - Sv, 0)
    return {"bad_records": bad,
            "misplaced_pct": 100.0 * misplaced / max(n_reads, 1),
            "introns_missed_pct": 100.0 * missed / max(n_introns, 1),
            "score_deficit_pct": 100.0 * float(deficit.sum()) /
            max(float(T.sum()), 1.0),
            "reads_judged": n_reads, "reads_repeated": repeated,
            "introns_judged": n_introns, "introns_moved_same_splice": moved,
            "reads_scored": len(T), "unaligned": int(np.sum(Sv <= 0))}


def numbers(res: dict, limits: dict) -> List[Tuple[str, float, float]]:
    """[(number, value, limit)] of every number that has a limit; a run is
    correct when no value passes its limit."""
    return [(name, res[name], lim) for name, lim in limits.items()]

