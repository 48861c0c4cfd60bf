"""The plain reference of the aligner's seeding: canonical minimizers and
a minimizer table looked up by binary search.

It imports nothing of the program, and is written from the semantics the
program states for its seeds, not from its code:

  * a k-mer at position i of a sequence of codes 0..3 (4 and above is an
    ambiguous base) is the 2-bit number of its bases, first base highest;
    its reverse complement is the same number of the complemented bases
    read backwards.  The canonical k-mer is the smaller of the two; its
    strand is 1 when the reverse complement is strictly smaller, so a
    palindrome is forward.  A k-mer that covers an ambiguous base has no
    value;
  * its hash is minimap2's invertible 64-bit integer hash (`hash64` in
    minimap2's sketch.c) of the canonical k-mer, every step masked to 2k
    bits;
  * each run of w consecutive k-mer positions elects the position of its
    smallest hash, the leftmost on a tie; a window whose k-mers all lack
    a value elects nothing, and a position elected by several windows in
    a row is kept once;
  * the table holds every chromosome's minimizers at global positions
    (the chromosome's offset in the concatenated genome added), sorted by
    hash and, within a hash, by position; hashes that occur more often
    than the occurrence cap are dropped (minimap2 -f): the cap is the
    smallest count c for which the distinct hashes seen at most c times
    (counts of 1024 and more pooled) make up at least 1 - max_frac of
    the distinct hashes, and never below min_cap;
  * a lookup of a hash is the half-open range [lo, hi) of table entries
    that carry it.

Numpy only, in plain passes; for small genomes (tests and the CPU
miniatures), not for a whole human genome.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_NONE = np.iinfo(np.uint64).max


def kmers(codes: np.ndarray, k: int):
    """(canonical k-mer, strand, has a value) at each of the
    len(codes) - k + 1 positions."""
    codes = np.asarray(codes)
    n = len(codes) - k + 1
    if n <= 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int8),
                np.zeros(0, bool))
    base = codes.astype(np.int64)
    ambiguous = base >= 4
    b = np.where(ambiguous, 0, base).astype(np.uint64)
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for j in range(k):
        weight = np.uint64(4) ** np.uint64(k - 1 - j)
        # forward: base i + j is digit j; reverse complement: the
        # complement of base i + k - 1 - j is digit j
        fwd += b[j: j + n] * weight
        rev += (np.uint64(3) - b[k - 1 - j: k - 1 - j + n]) * weight
    bad = np.convolve(ambiguous.astype(np.int64), np.ones(k, np.int64),
                      mode="valid") > 0
    strand = (rev < fwd).astype(np.int8)
    return np.minimum(fwd, rev), strand, ~bad


def hash64(key: np.ndarray, k: int) -> np.ndarray:
    """minimap2's hash64 over 2k bits."""
    m = np.uint64((1 << (2 * k)) - 1)
    x = np.asarray(key, np.uint64)
    x = (~x + (x << np.uint64(21))) & m
    x = x ^ (x >> np.uint64(24))
    x = ((x + (x << np.uint64(3))) + (x << np.uint64(8))) & m
    x = x ^ (x >> np.uint64(14))
    x = ((x + (x << np.uint64(2))) + (x << np.uint64(4))) & m
    x = x ^ (x >> np.uint64(28))
    x = (x + (x << np.uint64(31))) & m
    return x


def minimizers(codes: np.ndarray, k: int, w: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hash, position, strand) of the minimizers of one sequence, in
    order of position."""
    canon, strand, ok = kmers(codes, k)
    n = len(canon)
    if n < w:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, np.int8))
    h = np.where(ok, hash64(canon, k), _NONE)
    # the leftmost smallest of each window: scan its w offsets in order,
    # taking an offset only when strictly smaller than the best so far
    best = h[: n - w + 1].copy()
    at = np.arange(n - w + 1, dtype=np.int64)
    for off in range(1, w):
        cand = h[off: off + n - w + 1]
        take = cand < best
        best = np.where(take, cand, best)
        at = np.where(take, np.arange(n - w + 1) + off, at)
    elected = at[best != _NONE]
    pos = elected[np.r_[True, elected[1:] != elected[:-1]]] \
        if len(elected) else elected
    return h[pos], pos, strand[pos]


def occurrence_cap(counts: np.ndarray, max_frac: float, min_cap: int
                   ) -> int:
    """The occurrence cap of a table whose distinct hashes occur `counts`
    times."""
    if not len(counts):
        return 0
    pooled = np.minimum(counts, 1024)
    weight = np.bincount(pooled, minlength=1025)
    want = (1.0 - max_frac) * weight.sum()
    covered = np.cumsum(weight)
    cap = int(np.flatnonzero(covered >= want)[0])
    return max(cap, min_cap)


def build_table(chroms: List[np.ndarray], k: int, w: int,
                max_frac: float = 2e-4, min_cap: int = 50):
    """(hashes, positions, strands) of the sorted, capped minimizer table
    of a genome given as its chromosomes' codes, in order."""
    hs, ps, ss = [], [], []
    offset = 0
    for codes in chroms:
        h, p, s = minimizers(codes, k, w)
        hs.append(h)
        ps.append(p + offset)
        ss.append(s)
        offset += len(codes)
    h, p, s = np.concatenate(hs), np.concatenate(ps), np.concatenate(ss)
    order = np.lexsort((p, h))
    h, p, s = h[order], p[order], s[order]
    _, inverse, counts = np.unique(h, return_inverse=True,
                                   return_counts=True)
    cap = occurrence_cap(counts, max_frac, min_cap)
    keep = counts[inverse] <= cap
    return h[keep], p[keep], s[keep]


def lookup(table: np.ndarray, queries: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi) of each query hash in a sorted table."""
    q = np.asarray(queries, np.uint64)
    t = np.asarray(table, np.uint64)
    return (np.searchsorted(t, q, side="left").astype(np.int64),
            np.searchsorted(t, q, side="right").astype(np.int64))
