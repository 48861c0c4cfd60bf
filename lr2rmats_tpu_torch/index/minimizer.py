"""Minimizer extraction + sorted genome index.

Replaces minimap2's seeding stage (`minimap2 -x splice`: k=15, w=5).  All
extraction is vectorized; the index is a hash-sorted (hash, pos, strand)
array queried with searchsorted — a TPU/XLA-friendly layout (no pointer
chasing, no open addressing; reference SURVEY §7 "hard parts" #5).

Positions are stored as global offsets into the concatenated genome buffer;
chromosome id/coordinates are recovered via the offsets table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..io.fasta import Genome, SeqSet
from ..utils import log

K_DEFAULT = 15
W_DEFAULT = 5


def _hash64(x: np.ndarray, mask: np.int64) -> np.ndarray:
    """Invertible finalizer hash (murmur-style), vectorized.

    Same role as minimap2's hash64: decorrelates lexicographic k-mer order
    so window minima are pseudo-random.
    """
    x = x.astype(np.uint64)
    m = np.uint64(mask)
    x = (~x + (x << np.uint64(21))) & m
    x = x ^ (x >> np.uint64(24))
    x = (x + (x << np.uint64(3)) + (x << np.uint64(8))) & m
    x = x ^ (x >> np.uint64(14))
    x = (x + (x << np.uint64(2)) + (x << np.uint64(4))) & m
    x = x ^ (x >> np.uint64(28))
    x = (x + (x << np.uint64(31))) & m
    return x


def kmer_codes(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement 2-bit packed k-mers at every position.

    Returns (fwd, rc) uint64 arrays of length len(codes)-k+1 plus a validity
    mask is encoded by callers via the `valid_kmer` helper.
    """
    n = len(codes) - k + 1
    if n <= 0:
        z = np.zeros(0, np.uint64)
        return z, z
    c = np.bitwise_and(codes, 3).astype(np.uint64)
    comp = np.bitwise_and(3 - codes.astype(np.int8), 3).astype(np.uint64)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    two = np.uint64(2)
    for j in range(k):
        np.left_shift(fwd, two, out=fwd)
        np.bitwise_or(fwd, c[j: j + n], out=fwd)
        # rc: complement of base at position k-1-j goes into high bits order
        np.left_shift(rc, two, out=rc)
        np.bitwise_or(rc, comp[k - 1 - j: k - 1 - j + n], out=rc)
    return fwd, rc


def valid_kmer(codes: np.ndarray, k: int) -> np.ndarray:
    """Mask of k-mer windows containing no ambiguous base."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, bool)
    bad = (codes >= 4).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad, dtype=np.int64)])
    return (cs[k:] - cs[:-k]) == 0


def extract_minimizers(codes: np.ndarray, k: int = K_DEFAULT, w: int = W_DEFAULT
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dispatch to the native extractor when available (bit-equal)."""
    from ..native import get_lib
    lib = get_lib()
    if lib is not None and len(codes) >= k + w:
        cap = len(codes)
        out_h = np.empty(cap, np.uint64)
        out_p = np.empty(cap, np.int64)
        out_s = np.empty(cap, np.int8)
        n = lib.extract_minimizers_c(
            np.ascontiguousarray(codes, np.uint8), len(codes), k, w,
            out_h, out_p, out_s)
        return out_h[:n].copy(), out_p[:n].copy(), out_s[:n].copy()
    return extract_minimizers_np(codes, k, w)


def extract_minimizers_np(codes: np.ndarray, k: int = K_DEFAULT,
                          w: int = W_DEFAULT
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hash, pos, strand) minimizers of one sequence.

    strand=0 when the forward k-mer is canonical, 1 when the reverse
    complement is.  Strand-ambiguous (palindromic) k-mers are kept as
    forward.  Window minima are computed via a stacked min over w shifted
    views (w is small), then deduplicated on (pos).
    """
    n = len(codes) - k + 1
    if n < w:
        z = np.zeros(0, np.int64)
        return np.zeros(0, np.uint64), z, z.astype(np.int8)
    mask = (1 << (2 * k)) - 1
    fwd, rc = kmer_codes(codes, k)
    ok = valid_kmer(codes, k)
    strand = (rc < fwd).astype(np.int8)
    canon = np.where(rc < fwd, rc, fwd)
    h = _hash64(canon, mask)
    # invalid k-mers get +inf-like hash so they never win a window
    h = np.where(ok, h, np.uint64(0xFFFFFFFFFFFFFFFF))

    nw = n - w + 1
    stack = np.lib.stride_tricks.sliding_window_view(h, w)  # [nw, w]
    win_min = stack.min(axis=1)
    # position of min within window (leftmost, like argmin)
    arg = stack.argmin(axis=1)
    pos = np.arange(nw, dtype=np.int64) + arg
    # dedup identical (pos) picks from adjacent windows
    keep = np.ones(nw, bool)
    keep[1:] = pos[1:] != pos[:-1]
    # drop windows whose min is invalid
    keep &= win_min != np.uint64(0xFFFFFFFFFFFFFFFF)
    pos = pos[keep]
    return h[pos], pos, strand[pos]


@dataclass
class MinimizerIndex:
    """Hash-sorted minimizer table over the whole genome."""

    k: int
    w: int
    hashes: np.ndarray      # uint64 [m] sorted
    pos: np.ndarray         # int64 [m] global offsets (k-mer start)
    strand: np.ndarray      # int8  [m]
    chrom_offsets: np.ndarray  # int64 [n_chrom+1]
    names: list
    max_occ: int = 0        # high-frequency cutoff applied (0 = none)

    @classmethod
    def _extract_sorted(cls, genome: Genome, k: int, w: int,
                        hash_shard=None):
        """Hash-sorted (h, p, s) minimizer arrays + the 1025-bucket
        per-hash occurrence histogram (counts >= 1024 pooled).

        hash_shard=(sid, n) keeps only minimizers with hash % n == sid —
        the per-chromosome filter runs BEFORE the arrays concatenate, so
        build-time peak memory scales ~1/n too.  Every hash lives in
        exactly one shard and the sort is stable, so the stable hash-sort
        of the concatenated shard tables is bit-identical to the unsharded
        table (tested, tests/test_shard_index.py)."""
        # mod-sharding (h % n == sid): every hash lives in exactly one
        # shard AND shards balance even though minimizer hashes skew low
        # (window minima) — contiguous hash ranges don't
        sid = n_shards = None
        if hash_shard is not None:
            sid, n_shards = hash_shard
        hs, ps, ss = [], [], []
        for tid in range(genome.n):
            codes = genome.get(tid)
            h, p, s = extract_minimizers(codes, k, w)
            if sid is not None:
                keep = (h % np.uint64(n_shards)) == np.uint64(sid)
                h, p, s = h[keep], p[keep], s[keep]
            hs.append(h)
            ps.append(p + genome.offsets[tid])
            ss.append(s)
        # incremental concat: copy each per-chromosome part then free it,
        # so the resident peak is ~1x the table instead of the 2x a plain
        # np.concatenate holds (parts + output; ~18 GB extra at GRCh38
        # shard scale — output pages materialize lazily as parts free)
        total = sum(len(x) for x in hs)
        h = np.empty(total, np.uint64)
        p = np.empty(total, np.int64)
        s = np.empty(total, np.int8)
        off = 0
        for i in range(len(hs)):
            n = len(hs[i])
            h[off: off + n] = hs[i]
            p[off: off + n] = ps[i]
            s[off: off + n] = ss[i]
            hs[i] = ps[i] = ss[i] = None
            off += n
        del hs, ps, ss
        hist = np.zeros(1025, np.int64)
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and len(h):
            # threaded native radix sort + run-length histogram (numpy
            # argsort/unique cannot reach the ~1G-entry GRCh38 table)
            import os
            h = np.ascontiguousarray(h)
            p = np.ascontiguousarray(p)
            s = np.ascontiguousarray(s)
            lib.sort_minimizer_table_c(h, p, s, len(h),
                                       min(8, os.cpu_count() or 1), hist)
        elif len(h):
            order = np.argsort(h, kind="stable")
            h, p, s = h[order], p[order], s[order]
            _, counts = np.unique(h, return_counts=True)
            np.add.at(hist, np.minimum(counts, 1024), 1)
        return h, p, s, hist

    @staticmethod
    def occ_cap_from_hist(hist: np.ndarray, max_occ_frac: float,
                          min_max_occ: int) -> int:
        """max_occ from a per-hash occurrence histogram (sum the shard
        histograms first for a cap that is identical at every shard
        count)."""
        total = int(hist.sum())
        if not total:
            return 0
        want = (1.0 - max_occ_frac) * total
        cum = np.cumsum(hist)
        return max(int(np.searchsorted(cum, want)), min_max_occ)

    @staticmethod
    def _apply_cap(h, p, s, max_occ: int, hist: np.ndarray):
        """Drop hashes with more than max_occ occurrences (minimap2 -f)."""
        if not len(h):
            return h, p, s
        if hist[min(max_occ + 1, 1024):].sum() == 0 and max_occ < 1024:
            return h, p, s
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            n2 = int(lib.cap_occurrences_c(h, p, s, len(h), max_occ))
            return h[:n2].copy(), p[:n2].copy(), s[:n2].copy()
        uh, counts = np.unique(h, return_counts=True)
        bad = uh[counts > max_occ]
        if len(bad):
            drop = np.isin(h, bad)
            h, p, s = h[~drop], p[~drop], s[~drop]
        return h, p, s

    @classmethod
    def build(cls, genome: Genome, k: int = K_DEFAULT, w: int = W_DEFAULT,
              max_occ_frac: float = 2e-4, min_max_occ: int = 50,
              hash_shard=None, occ_hist=None) -> "MinimizerIndex":
        """Build the (optionally hash-range-sharded) table.

        hash_shard=(sid, n): keep only the sid-th of n uint64 hash ranges
        (SURVEY §5 long-genome arm: one shard per host, ~1/n RSS).
        occ_hist: externally reduced global occurrence histogram — pass the
        SUM of every shard's `occ_hist` attribute so the high-frequency cap
        is identical regardless of shard count; without it the cap comes
        from the local histogram (exact for unsharded builds)."""
        shard_note = (" [shard %d/%d]" % hash_shard) if hash_shard else ""
        log("index", "building minimizer index (k=%d, w=%d)%s ...", k, w,
            shard_note)
        h, p, s, hist = cls._extract_sorted(genome, k, w, hash_shard)
        max_occ = cls.occ_cap_from_hist(
            occ_hist if occ_hist is not None else hist,
            max_occ_frac, min_max_occ) if len(h) else 0
        if len(h):
            h, p, s = cls._apply_cap(h, p, s, max_occ, hist)
        log("index", "minimizer index done: %d minimizers (max_occ=%d)%s",
            len(h), max_occ, shard_note)
        out = cls(k, w, h, p, s, genome.offsets.copy(), list(genome.names),
                  max_occ)
        out.occ_hist = hist
        return out

    def _ensure_buckets(self) -> None:
        """Prefix-bucket table over the sorted hashes: bucket b covers
        hashes with (h >> shift) == b, so per-query binary search narrows to
        ~a dozen entries."""
        # guard on the LAST attribute assigned so a concurrent reader
        # (seed worker vs build worker's rescue lookups) never sees a
        # half-initialized bucket table
        if getattr(self, "_nbuckets", None) is not None:
            return
        # bucket count ~4x the table size caps the per-query binary search
        # at ~1 step (22 bits = 33 MB of starts — noise next to the table);
        # smaller tables get proportionally fewer buckets
        nbits = min(22, max(12, int(np.ceil(np.log2(max(len(self.hashes),
                                                        2)))) + 2))
        self._bshift = max(0, 2 * self.k - nbits)
        nb = 1 << min(nbits, 2 * self.k)
        edges = (np.arange(nb, dtype=np.uint64) << np.uint64(self._bshift))
        starts = np.searchsorted(self.hashes, edges, side="left")
        self._bstart = np.concatenate(
            [starts, [len(self.hashes)]]).astype(np.int64)
        self._nbuckets = nb

    def lookup(self, qhashes: np.ndarray, n_threads: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        """searchsorted range per query hash -> (lo, hi) index arrays.

        Dispatches to the native bucketed lookup when available (threaded
        over query ranges for large batches)."""
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and len(qhashes):
            self._ensure_buckets()
            q = np.ascontiguousarray(qhashes, np.uint64)
            lo = np.empty(len(q), np.int64)
            hi = np.empty(len(q), np.int64)
            lib.lookup_range_mt_c(self.hashes, len(self.hashes),
                                  self._bstart, self._nbuckets, self._bshift,
                                  q, len(q), lo, hi, n_threads)
            return lo, hi
        lo = np.searchsorted(self.hashes, qhashes, side="left")
        hi = np.searchsorted(self.hashes, qhashes, side="right")
        return lo, hi

    def global_to_chrom(self, gpos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """global offset -> (tid, 0-based chrom offset)."""
        tid = np.searchsorted(self.chrom_offsets, gpos, side="right") - 1
        return tid.astype(np.int32), (gpos - self.chrom_offsets[tid])

    # ------------------------------------------------------------- caching
    @staticmethod
    def genome_signature(genome) -> str:
        """FULL-coverage content signature of a genome: names, offsets,
        and a chunked blake2b over every code byte (~1 GB/s; ~3 s at
        GRCh38 scale, noise next to an index build).  A rewritten genome
        with identical names must invalidate the index cache — a stale
        cache silently mis-places every seed.  An earlier strided sample
        (~0.1% byte coverage at 3 Gbp) missed small in-place edits
        between sample points, reintroducing exactly that failure."""
        import hashlib
        h = hashlib.blake2b(digest_size=20)
        h.update(("|".join(genome.names)).encode())
        h.update(np.asarray(genome.offsets, np.int64).tobytes())
        codes = genome.codes
        CH = 1 << 26
        for off in range(0, len(codes), CH):
            h.update(codes[off: off + CH])
        return h.hexdigest()

    def save(self, path: str, genome_sig: str = "",
             compress: bool = True) -> None:
        """Persist the index (the minimap_idx_file artifact role,
        reference config.yaml:6-9).  compress=False for multi-GB tables:
        single-threaded zlib over ~9 GB of near-random hashes costs
        minutes for a modest ratio."""
        (np.savez_compressed if compress else np.savez)(
            path, k=self.k, w=self.w, hashes=self.hashes, pos=self.pos,
            strand=self.strand, chrom_offsets=self.chrom_offsets,
            names=np.asarray(self.names, object), max_occ=self.max_occ,
            genome_sig=genome_sig)

    @classmethod
    def load(cls, path: str) -> "MinimizerIndex":
        z = np.load(path, allow_pickle=True)
        out = cls(int(z["k"]), int(z["w"]), z["hashes"], z["pos"],
                  z["strand"], z["chrom_offsets"], list(z["names"]),
                  int(z["max_occ"]))
        out.genome_sig = str(z["genome_sig"]) if "genome_sig" in z else ""
        return out

    def save_raw(self, dir_path: str, genome_sig: str = "") -> None:
        """Directory-of-.npy format for multi-GB tables: each array is a
        plain .npy so load_raw can MEMORY-MAP it (npz members cannot be
        mmapped — numpy silently ignores mmap_mode inside a zip).
        Measured: eager np.load of an 8.9 GB shard npz cost ~295 s under
        2-process disk contention; a mapped load is instant and pages
        fault in under the actual lookups."""
        import json as _json
        import os as _os
        _os.makedirs(dir_path, exist_ok=True)
        np.save(_os.path.join(dir_path, "hashes.npy"), self.hashes)
        np.save(_os.path.join(dir_path, "pos.npy"), self.pos)
        np.save(_os.path.join(dir_path, "strand.npy"), self.strand)
        np.save(_os.path.join(dir_path, "chrom_offsets.npy"),
                self.chrom_offsets)
        meta = {"k": self.k, "w": self.w, "names": list(self.names),
                "max_occ": int(self.max_occ), "genome_sig": genome_sig}
        tmp = _os.path.join(dir_path, "meta.json.tmp")
        with open(tmp, "w") as f:
            _json.dump(meta, f)
        _os.replace(tmp, _os.path.join(dir_path, "meta.json"))

    @classmethod
    def load_raw(cls, dir_path: str, mmap: bool = True) -> "MinimizerIndex":
        import json as _json
        import os as _os
        with open(_os.path.join(dir_path, "meta.json")) as f:
            meta = _json.load(f)
        mode = "r" if mmap else None
        out = cls(int(meta["k"]), int(meta["w"]),
                  np.load(_os.path.join(dir_path, "hashes.npy"),
                          mmap_mode=mode),
                  np.load(_os.path.join(dir_path, "pos.npy"),
                          mmap_mode=mode),
                  np.load(_os.path.join(dir_path, "strand.npy"),
                          mmap_mode=mode),
                  np.load(_os.path.join(dir_path, "chrom_offsets.npy")),
                  list(meta["names"]), int(meta["max_occ"]))
        out.genome_sig = str(meta.get("genome_sig", ""))
        return out

    @classmethod
    def build_or_load(cls, genome, cache_path: Optional[str] = None,
                      k: int = K_DEFAULT, w: int = W_DEFAULT) -> "MinimizerIndex":
        """Reuse a cached index when fresh ("lr2rmats will build them if
        they do not exist", reference config.yaml:7).  Freshness =
        (k, w, chrom names) AND the genome CONTENT signature — a cache
        written for an older genome with the same file name must rebuild
        (caught live: a stale .tmmi.npz dropped 99.9%% of alignments)."""
        import os
        sig = cls.genome_signature(genome)
        if cache_path and os.path.exists(cache_path):
            try:
                idx = cls.load(cache_path)
                if (idx.k == k and idx.w == w and
                        idx.names == list(genome.names) and
                        idx.genome_sig == sig):
                    log("index", "loaded cached minimizer index from %s",
                        cache_path)
                    return idx
                if (idx.k == k and idx.w == w and
                        idx.names == list(genome.names)):
                    # same genome names/params but signature mismatch:
                    # either the genome content was rewritten in place, or
                    # the cache predates the current signature scheme
                    # (round-4 change: sampled sha1 -> full blake2b) — a
                    # one-time rebuild either way (ADVICE r4)
                    log("index", "cache %s rejected: genome content "
                        "signature mismatch (genome rewritten, or cache "
                        "written by an older signature scheme); "
                        "rebuilding once", cache_path)
                else:
                    log("index", "cache %s is stale (k/w/chromosomes "
                        "changed); rebuilding", cache_path)
            except Exception as e:
                log("index", "cache %s unreadable (%r); rebuilding",
                    cache_path, e)
        idx = cls.build(genome, k, w)
        if cache_path:
            try:
                idx.save(cache_path, genome_sig=sig)
            except OSError:
                pass
        return idx
