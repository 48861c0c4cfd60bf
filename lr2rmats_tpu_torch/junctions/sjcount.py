"""Short-read junction-support counting — the STAR SJ.out.tab role.

The reference pipeline runs STAR against the long-read-augmented GTF purely
to obtain per-junction short-read support counts (reference Snakefile:116-140;
only SJ.out.tab is consumed downstream, Snakefile:148,170).  This module
replaces that with a batched junction-context matcher:

  1. candidate junctions = introns of (annotation + pass-1 novel) GTF
     (the --sjdbGTFfile role)
  2. each junction gets a spliced context sequence: OH bases of donor-side
     exon + OH bases of acceptor-side exon
  3. short reads are placed by k-mer seeding + mismatch verification against
     genome and contexts; a read supports a junction when its best placement
     crosses the junction with >= min_overhang on both sides and beats every
     contiguous genomic placement
  4. uniq_c / multi_c from placement-count uniqueness, max_over tracked

Placement verification runs through the native batch kernels
(csrc/lrio.cpp: lookup_range_c + hamming_pairs_c) with numpy fallbacks;
count_seqset_batched is the production path, count_seqset/add_read the
per-read reference it is agreement-tested against.

The device backend (LR2RMATS_DEVICE_SJCOUNT=1, or backend="device") runs
the Hamming verify on csrc/hamming.cu and the count scatters as torch ops
on `device` (junctions/sjcount_device.py; the plain PyTorch versions on the
CPU).  It has no int32 addressing limit, so unlike the reference's it never
falls back to the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.fasta import Genome, SeqSet, revcomp
from ..io.sj import SJTable
from ..transcript.model import Transcripts
from ..utils import log
from ..utils.log import count, span
from .bam2sj import intron_motif_of

# peak combos materialized at once by count_pairs_batched's mate
# cross-product (~7 int64/bool arrays of this length ≈ 200 MB)
_PAIR_COMBO_CHUNK = 1 << 22


@dataclass
class SJCountParams:
    overhang: int = 100          # sjdbOverhang (Snakefile:140)
    min_overhang: int = 8        # alignSJoverhangMin (Snakefile:140)
    min_db_overhang: int = 5     # alignSJDBoverhangMin
    seed_k: int = 20
    max_mm_frac: float = 0.06    # per-read mismatch budget
    seeds_per_read: int = 3
    max_mates_gap: int = 300_000  # paired-end concordance window (STAR's
                                  # winBinNbits-derived mates gap is ~262k)


def gather_junctions(transcripts: List[Transcripts], min_intron: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Distinct (tid, don, acc) introns over transcript sets; is_anno flags
    the first set (the annotation)."""
    tids, dons, accs, anno = [], [], [], []
    for si, T in enumerate(transcripts):
        for i in range(T.n):
            d, a = T.junctions(i)
            for j in range(len(d)):
                don, acc = int(d[j]) + 1, int(a[j]) - 1  # intron 1st/last base
                if acc - don + 1 < min_intron:
                    continue
                tids.append(int(T.tid[i]))
                dons.append(don)
                accs.append(acc)
                anno.append(1 if si == 0 else 0)
    if not tids:
        z = np.zeros(0, np.int32)
        return z, z, z, z
    arr = np.stack([tids, dons, accs, anno])
    # dedup on (tid, don, acc); is_anno = max over dupes
    order = np.lexsort((arr[3] * -1, arr[2], arr[1], arr[0]))
    arr = arr[:, order]
    key = arr[:3]
    keep = np.ones(arr.shape[1], bool)
    keep[1:] = np.any(key[:, 1:] != key[:, :-1], axis=0)
    arr = arr[:, keep]
    return (arr[0].astype(np.int32), arr[1].astype(np.int32),
            arr[2].astype(np.int32), arr[3].astype(np.int32))


class JunctionCounter:
    def __init__(self, genome: Genome, tid: np.ndarray, don: np.ndarray,
                 acc: np.ndarray, is_anno: np.ndarray,
                 params: Optional[SJCountParams] = None,
                 backend: Optional[str] = None, device="cuda"):
        self.genome = genome
        self.p = params or SJCountParams()
        self.jtid, self.jdon, self.jacc, self.janno = tid, don, acc, is_anno
        self._build_contexts()
        self._build_seed_index()
        self.uniq_c = np.zeros(len(tid), np.int32)
        self.multi_c = np.zeros(len(tid), np.int32)
        self.max_over = np.zeros(len(tid), np.int32)
        # "device" routes the Hamming verify + count scatter-adds through
        # junctions/sjcount_device.py on `device` (env:
        # LR2RMATS_DEVICE_SJCOUNT=1)
        if backend is None:
            backend = ("device" if os.environ.get("LR2RMATS_DEVICE_SJCOUNT")
                       else "host")
        if backend not in ("host", "device"):
            raise ValueError(f"backend must be 'host' or 'device', got "
                             f"{backend!r}")
        self._dev_verifier = None
        self._dev_counts = None
        if backend == "device":
            from .sjcount_device import TorchCounts, TorchHammingVerifier
            self._dev_verifier = TorchHammingVerifier(self.buf, device)
            self._dev_counts = TorchCounts(len(tid), device)
        self.backend = backend

    # ------------------------------------------------------------- contexts
    def _build_contexts(self):
        OH = self.p.overhang
        g = self.genome
        parts = []
        self.ctx_left_len = np.zeros(len(self.jtid), np.int32)
        offs = [0]
        for j in range(len(self.jtid)):
            tid, don, acc = int(self.jtid[j]), int(self.jdon[j]), int(self.jacc[j])
            left = g.slice(tid, don - OH, don - 1)     # donor-side exon bases
            right = g.slice(tid, acc + 1, acc + OH)    # acceptor-side
            self.ctx_left_len[j] = len(left)
            parts.append(np.concatenate([left, right]))
            offs.append(offs[-1] + len(parts[-1]))
        self.ctx = (np.concatenate(parts) if parts else np.zeros(0, np.uint8))
        self.ctx_offs = np.asarray(offs, np.int64)

    # ----------------------------------------------------------- seed index
    def _kmers(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """k-mers at every position (table building); native one-pass scan
        when available — the numpy rolling construction is ~2k full-array
        passes and this image's numpy is bandwidth-fragile."""
        k = self.p.seed_k
        n = len(codes) - k + 1
        if n <= 0:
            return np.zeros(0, np.uint64), np.zeros(0, bool)
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            km = np.empty(n, np.uint64)
            ok = np.empty(n, np.int8)
            lib.kmer_scan_c(np.ascontiguousarray(codes, np.uint8),
                            len(codes), k, km, ok)
            return km, ok.astype(bool)
        c = np.bitwise_and(codes, 3).astype(np.uint64)
        km = np.zeros(n, np.uint64)
        for j in range(k):
            np.left_shift(km, np.uint64(2), out=km)
            np.bitwise_or(km, c[j: j + n], out=km)
        bad = (codes >= 4).astype(np.int64)
        cs = np.concatenate([[0], np.cumsum(bad)])
        ok = (cs[k:] - cs[:-k]) == 0
        return km, ok

    def _kmers_at(self, codes: np.ndarray, pos: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """k-mers at the given positions only (seed extraction: only
        seeds_per_read positions per read are used — scanning the whole
        read buffer wasted ~90% of the round-1 counting wall)."""
        k = self.p.seed_k
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            km = np.empty(len(pos), np.uint64)
            ok = np.empty(len(pos), np.int8)
            lib.kmers_at_c(np.ascontiguousarray(codes, np.uint8), len(codes),
                           k, np.ascontiguousarray(pos, np.int64), len(pos),
                           km, ok)
            return km, ok.astype(bool)
        n = len(codes)
        inb = (pos >= 0) & (pos + k <= n)
        safe = np.clip(pos, 0, max(n - k, 0))
        win = codes[safe[:, None] + np.arange(k)]
        ok = inb & (win < 4).all(axis=1)
        km = np.zeros(len(pos), np.uint64)
        for j in range(k):
            km = (km << np.uint64(2)) | (win[:, j].astype(np.uint64) &
                                         np.uint64(3))
        return km, ok

    def _genome_table(self):
        """Sorted genome seed table; native scan+compact+radix build when
        available (the numpy argsort + permutation path cost ~33 s at chr21
        scale and does not reach GRCh38)."""
        from ..native import get_lib
        lib = get_lib()
        codes = self.genome.codes
        k = self.p.seed_k
        m = max(len(codes) - k + 1, 0)
        if lib is None or m == 0:
            km, ok = self._kmers(codes)
            return self._sorted_table(km, ok, 0)
        h = np.empty(m, np.uint64)
        pos = np.empty(m, np.int64)
        cnt = int(lib.build_kmer_table_c(
            np.ascontiguousarray(codes, np.uint8), len(codes), k, 0, h, pos))
        h = h[:cnt].copy()
        pos = pos[:cnt].copy()
        nbits = 18
        shift = max(0, 2 * k - nbits)
        nb = 1 << min(nbits, 2 * k)
        edges = (np.arange(nb, dtype=np.uint64) << np.uint64(shift))
        starts = np.searchsorted(h, edges, side="left")
        bstart = np.concatenate([starts, [len(h)]]).astype(np.int64)
        return (h, pos, bstart, nb, shift)

    def _sorted_table(self, km, ok, pos_offset):
        valid = np.nonzero(ok)[0]
        kv = km[valid]
        order = np.argsort(kv, kind="stable")
        h = np.ascontiguousarray(kv[order])
        pos = valid[order] + pos_offset
        nbits = 18
        shift = max(0, 2 * self.p.seed_k - nbits)
        nb = 1 << min(nbits, 2 * self.p.seed_k)
        edges = (np.arange(nb, dtype=np.uint64) << np.uint64(shift))
        starts = np.searchsorted(h, edges, side="left")
        bstart = np.concatenate([starts, [len(h)]]).astype(np.int64)
        return (h, pos, bstart, nb, shift)

    def _build_seed_index(self):
        """Two seed tables: the GENOME table is built once and cached on the
        Genome object (junction sets change per sample, the genome doesn't);
        the small CONTEXT table is per-counter."""
        self.gn = len(self.genome.codes)
        self.buf = (np.concatenate([self.genome.codes, self.ctx])
                    if len(self.ctx) else self.genome.codes)
        cached = getattr(self.genome, "_sjk_cache", None)
        if cached is not None and cached[0] == self.p.seed_k:
            self._gtab = cached[1]
        else:
            self._gtab = self._genome_table()
            try:
                self.genome._sjk_cache = (self.p.seed_k, self._gtab)
            except AttributeError:
                pass  # frozen Genome: skip caching
        if len(self.ctx):
            km, ok = self._kmers(self.ctx)
            # suppress k-mers straddling context-segment boundaries
            k = self.p.seed_k
            for s0 in self.ctx_offs[1:-1]:
                ok[max(0, int(s0) - k + 1): int(s0)] = False
            self._ctab = self._sorted_table(km, ok, self.gn)
        else:
            self._ctab = self._sorted_table(
                np.zeros(0, np.uint64), np.zeros(0, bool), self.gn)

    def _lookup_tab(self, tab, h: np.ndarray):
        th, tpos, bstart, nb, shift = tab
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and len(h) and len(th):
            q = np.ascontiguousarray(h, np.uint64)
            lo = np.empty(len(q), np.int64)
            hi = np.empty(len(q), np.int64)
            lib.lookup_range_c(th, len(th), bstart, nb, shift, q, len(q),
                               lo, hi)
            return lo, hi
        return (np.searchsorted(th, h, side="left"),
                np.searchsorted(th, h, side="right"))

    def _hits(self, h: np.ndarray, cap_per_seed: int = 100):
        """Expand seed hits over both tables.

        Returns (rep, pos): rep[i] indexes into h; pos[i] is the hit's
        global buffer position.  Seeds whose COMBINED hit count exceeds
        cap_per_seed are dropped entirely (repetitive)."""
        lo_g, hi_g = self._lookup_tab(self._gtab, h)
        lo_c, hi_c = self._lookup_tab(self._ctab, h)
        cnt = (hi_g - lo_g) + (hi_c - lo_c)
        keep = (cnt > 0) & (cnt <= cap_per_seed)
        reps, poss = [], []
        for tab, lo, hi in ((self._gtab, lo_g, hi_g),
                            (self._ctab, lo_c, hi_c)):
            c = np.where(keep, hi - lo, 0).astype(np.int64)
            if not c.sum():
                continue
            tot = int(c.sum())
            starts = np.zeros(len(c) + 1, np.int64)
            np.cumsum(c, out=starts[1:])
            flat = (np.repeat(lo, c) +
                    (np.arange(tot) - np.repeat(starts[:-1], c)))
            poss.append(tab[1][flat])
            reps.append(np.repeat(np.arange(len(h)), c))
        if not reps:
            z = np.zeros(0, np.int64)
            return z, z
        return np.concatenate(reps), np.concatenate(poss)

    # ------------------------------------------------------------ placement
    def _place(self, read: np.ndarray) -> Tuple[int, List[Tuple[int, int]]]:
        """All best placements of one read (one orientation).

        Returns (best_mm, [(pos, mm)...]) over the combined buffer; only
        segment-respecting placements are considered.
        """
        p = self.p
        L = len(read)
        k = p.seed_k
        if L < k:
            return 10 ** 9, []
        km, ok = self._kmers(read)
        seed_at = np.linspace(0, L - k, p.seeds_per_read).astype(np.int64)
        seed_at = np.unique(seed_at)
        seed_ok = seed_at[ok[seed_at]]
        if not len(seed_ok):
            return 10 ** 9, []
        rep, pos = self._hits(km[seed_ok])
        cand = set((pos - seed_ok[rep]).tolist())
        if not cand:
            return 10 ** 9, []
        max_mm = int(p.max_mm_frac * L)
        n = len(self.buf)
        # segment-respecting candidates
        valid_pos = []
        goffs = self.genome.offsets
        for pos in cand:
            if pos < 0 or pos + L > n:
                continue
            if pos < self.gn:
                if pos + L > self.gn:
                    continue
                # genomic placements must stay within one chromosome
                t0 = np.searchsorted(goffs, pos, side="right") - 1
                if pos + L > goffs[t0 + 1]:
                    continue
            else:
                c0 = np.searchsorted(self.ctx_offs, pos - self.gn, side="right") - 1
                if pos + L - self.gn > self.ctx_offs[c0 + 1]:
                    continue
            valid_pos.append(pos)
        if not valid_pos:
            return 10 ** 9, []
        pos_arr = np.asarray(valid_pos, np.int64)
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            mm_arr = np.empty(len(pos_arr), np.int32)
            lib.hamming_many_c(self.buf, n, np.ascontiguousarray(read, np.uint8),
                               L, pos_arr, len(pos_arr), mm_arr)
        else:
            mm_arr = np.array([int(np.sum(self.buf[t: t + L] != read))
                               for t in pos_arr], np.int32)
        ok = mm_arr <= max_mm
        if not ok.any():
            return 10 ** 9, []
        best_mm = int(mm_arr[ok].min())
        sel = ok & (mm_arr == best_mm)
        return best_mm, [(int(t), best_mm) for t in pos_arr[sel]]

    def add_read(self, read: np.ndarray) -> None:
        """Place one read (both orientations) and accumulate junction counts."""
        p = self.p
        L = len(read)
        b1, pl1 = self._place(read)
        b2, pl2 = self._place(revcomp(read))
        best = min(b1, b2)
        if best >= 10 ** 9:
            return
        pls = ([x for x in pl1 if x[1] == best] +
               [x for x in pl2 if x[1] == best])
        # split into genomic vs junction-crossing context placements
        genomic, crossing = [], []
        for pos, mm in pls:
            if pos < self.gn:
                genomic.append((pos, mm))
                continue
            cpos = pos - self.gn
            c = int(np.searchsorted(self.ctx_offs, cpos, side="right") - 1)
            off = cpos - int(self.ctx_offs[c])
            left = int(self.ctx_left_len[c])
            lpart = left - off
            rpart = off + L - left
            if lpart >= p.min_overhang and rpart >= p.min_overhang:
                crossing.append((c, min(lpart, rpart)))
            else:
                # within one flank: equivalent to a genomic placement; dedup
                genomic.append((pos, mm))
        if not crossing:
            return
        # a crossing counts only when no contiguous genomic placement ties it
        # (a within-flank context placement always has a genomic mirror hit,
        # so checking true genomic positions suffices)
        has_genomic_tie = any(pos < self.gn for pos, _ in pls)
        if has_genomic_tie:
            return
        uniq = len(crossing) == 1
        for c, over in crossing:
            if uniq:
                self.uniq_c[c] += 1
            else:
                self.multi_c[c] += 1
            self.max_over[c] = max(self.max_over[c], over)

    def count_seqset(self, reads: SeqSet) -> None:
        for i in range(reads.n):
            self.add_read(reads.get(i))

    # --------------------------------------------------- batched counting
    def count_seqset_batched(self, reads: SeqSet) -> None:
        """Vectorized equivalent of per-read add_read (agreement tested in
        tests/test_sjcount.py::test_batched_matches_per_read)."""
        placed = self._place_batched(reads)
        if placed is None:
            return
        (ri, cp, ori, L, c0, in_genome, mm, grp_start, is_best,
         lpart, rpart) = placed
        p = self.p
        crossing = (~in_genome) & (lpart >= p.min_overhang) & \
            (rpart >= p.min_overhang) & is_best
        genomic_tie = in_genome & is_best
        grp_sizes = np.diff(np.concatenate([grp_start, [len(ri)]]))
        cross_cnt = np.add.reduceat(crossing.astype(np.int64), grp_start)
        tie_cnt = np.add.reduceat(genomic_tie.astype(np.int64), grp_start)
        count_grp = (cross_cnt > 0) & (tie_cnt == 0)
        uniq_grp = count_grp & (cross_cnt == 1)
        count_per_cand = np.repeat(count_grp, grp_sizes)
        uniq_per_cand = np.repeat(uniq_grp, grp_sizes)
        sel = crossing & count_per_cand
        cc = c0[sel]
        over = np.minimum(lpart[sel], rpart[sel]).astype(np.int32)
        u = uniq_per_cand[sel]
        if self._dev_counts is not None:
            self._dev_counts.add(cc, u, over)
        else:
            np.add.at(self.uniq_c, cc[u], 1)
            np.add.at(self.multi_c, cc[~u], 1)
            np.maximum.at(self.max_over, cc, over)

    def count_pairs_batched(self, reads1: SeqSet, reads2: SeqSet) -> None:
        """Paired-end counting with mate-consistency gating (the STAR
        proper-pair analog, reference parse_bam.c:909-914 consumes
        FPROPER_PAIR alignments): a junction crossing counts only when its
        placement participates in a concordant pair — mates on opposite
        strands of the same chromosome within max_mates_gap.  Discordant
        pairs contribute nothing (tests/test_sjcount.py).

        Spans (utils/log.py): the batch is one call, `_place_batched`'s
        seed, verify and best phases run for each mate, then the pairing
        and the counting."""
        assert reads1.n == reads2.n, "mate files differ in read count"
        with span("lr2rmats.sr.call"):
            self._count_pairs(reads1, reads2)

    def _count_pairs(self, reads1: SeqSet, reads2: SeqSet) -> None:
        p = self.p
        R = reads1.n
        if R == 0:
            return
        placed = [self._place_batched(rs) for rs in (reads1, reads2)]
        if placed[0] is None or placed[1] is None:
            return
        with span("lr2rmats.sr.pair"):
            goffs = self.genome.offsets
            # junction anchor, global
            jglobal = goffs[self.jtid] + self.jdon

            def best_arrays(P):
                (ri, cp, ori, L, c0, in_genome, mm, grp_start, is_best,
                 lpart, rpart) = P
                sel = is_best
                ri, cp, ori, c0, in_genome, lp, rp = (
                    ri[sel], cp[sel], ori[sel], c0[sel], in_genome[sel],
                    lpart[sel], rpart[sel])
                # global genomic anchor + chromosome for concordance checks
                tid = np.where(
                    in_genome,
                    np.clip(np.searchsorted(goffs, cp, side="right") - 1, 0,
                            len(goffs) - 2),
                    self.jtid[np.clip(c0, 0, max(len(self.jtid) - 1, 0))])
                anchor = np.where(in_genome, cp,
                                  jglobal[np.clip(c0, 0,
                                                  max(len(self.jtid) - 1, 0))])
                crossing = (~in_genome) & (lp >= p.min_overhang) & \
                    (rp >= p.min_overhang)
                over = np.minimum(lp, rp).astype(np.int32)
                # per-read offsets over 0..R-1
                counts = np.bincount(ri, minlength=R)
                offs = np.zeros(R + 1, np.int64)
                np.cumsum(counts, out=offs[1:])
                order = np.argsort(ri, kind="stable")
                return (ri[order], ori[order], tid[order], anchor[order],
                        crossing[order], c0[order], over[order],
                        in_genome[order], offs)

            r1 = best_arrays(placed[0])
            r2 = best_arrays(placed[1])
            offs1, offs2 = r1[8], r2[8]
            n1 = np.diff(offs1)
            n2 = np.diff(offs2)
            ncomb = (n1 * n2).astype(np.int64)
            tot = int(ncomb.sum())
            count("lr2rmats.sr.combos", tot)
            if tot == 0:
                return
            cstart = np.zeros(R + 1, np.int64)
            np.cumsum(ncomb, out=cstart[1:])
            # the placement cross-product is evaluated in bounded chunks of
            # reads: repeat-heavy pairs can hold 10^2-10^3 tied best
            # placements per mate, and one dense n1*n2 materialization over a
            # whole read set would be tens of GB — chunking keeps the peak at
            # ~_PAIR_COMBO_CHUNK combos with results identical to one pass
            n_concord = np.zeros(R, np.int64)
            part1 = np.zeros(len(r1[0]), bool)
            part2 = np.zeros(len(r2[0]), bool)
            lo_r = 0
            while lo_r < R:
                hi_r = int(np.searchsorted(
                    cstart, cstart[lo_r] + _PAIR_COMBO_CHUNK, side="left"))
                hi_r = min(max(hi_r, lo_r + 1), R)
                g0, g1 = int(cstart[lo_r]), int(cstart[hi_r])
                nt = g1 - g0
                if nt:
                    pair_of = np.repeat(np.arange(lo_r, hi_r),
                                        ncomb[lo_r: hi_r])
                    within = np.arange(g0, g1) - cstart[pair_of]
                    i1 = offs1[pair_of] + within // np.maximum(n2[pair_of], 1)
                    i2 = offs2[pair_of] + within % np.maximum(n2[pair_of], 1)
                    concord = ((r1[1][i1] != r2[1][i2]) &
                               (r1[2][i1] == r2[2][i2]) &
                               (np.abs(r1[3][i1] - r2[3][i2])
                                <= p.max_mates_gap))
                    # reduceat needs in-bounds indices; empty pair groups
                    # (ncomb == 0) are clipped then zeroed
                    nc = np.add.reduceat(
                        concord.astype(np.int64),
                        np.minimum(cstart[lo_r: hi_r] - g0, nt - 1))
                    nc[ncomb[lo_r: hi_r] == 0] = 0
                    n_concord[lo_r: hi_r] = nc
                    # placements participating in >= 1 concordant combo
                    np.logical_or.at(part1, i1, concord)
                    np.logical_or.at(part2, i2, concord)
                lo_r = hi_r
            uniq_pair = n_concord == 1
            ok_pair = n_concord >= 1
        with span("lr2rmats.sr.count"):
            for (ri_m, ori_m, tid_m, anc_m, cross_m, c0_m, over_m, ing_m,
                 offs_m), part in ((r1, part1), (r2, part2)):
                # per-mate genomic tie: a participating contiguous placement
                # beats the junction interpretation (single-end tie analog)
                tie = np.zeros(R, bool)
                np.logical_or.at(tie, ri_m[part & ing_m], True)
                sel = part & cross_m & ok_pair[ri_m] & ~tie[ri_m]
                cc = c0_m[sel]
                u = uniq_pair[ri_m[sel]]
                if self._dev_counts is not None:
                    self._dev_counts.add(cc, u, over_m[sel])
                else:
                    np.add.at(self.uniq_c, cc[u], 1)
                    np.add.at(self.multi_c, cc[~u], 1)
                    np.maximum.at(self.max_over, cc, over_m[sel])

    def _place_batched(self, reads: SeqSet):
        """Shared batched placement pass: seeds, hits, verification, best
        marking.  Returns per-candidate arrays sorted/grouped by read, or
        None when nothing placed."""
        with span("lr2rmats.sr.seed"):
            from ..native import get_lib
            lib = get_lib()
            p = self.p
            k = p.seed_k
            R = reads.n
            if R == 0:
                return None
            # forward + reverse-complement concatenated read buffers
            fwd = reads.codes
            offs = reads.offsets
            total = int(offs[-1])
            from ..io.fasta import revcomp
            rc_all = revcomp(fwd)  # reverses segment order too
            # rc read i lives at [total - offs[i+1], total - offs[i])
            lens = (offs[1:] - offs[:-1]).astype(np.int64)

            # seeds: seeds_per_read positions per read per orientation, k-mers
            # computed only AT those positions (kmers_at_c)
            seed_frac = np.linspace(0, 1, p.seeds_per_read)
            nf = len(seed_frac)
            cand_read = []
            cand_pos = []
            rid_tile = np.tile(np.arange(R, dtype=np.int64), nf)
            len_ok_tile = np.tile(lens >= k, nf)
            for codes_all, is_rc in ((fwd, False), (rc_all, True)):
                base = (total - offs[1:]) if is_rc else offs[:-1]
                sp = np.concatenate(
                    [base + np.maximum((frac * (lens - k)).astype(np.int64), 0)
                     for frac in seed_frac])
                km, okm = self._kmers_at(codes_all, sp)
                good = okm & len_ok_tile
                idx = np.nonzero(good)[0]
                if not len(idx):
                    continue
                rep, tpos = self._hits(km[idx])
                if not len(rep):
                    continue
                seed_in_read = (sp[idx] - base[rid_tile[idx]])[rep]
                diag = tpos - seed_in_read
                rr = rid_tile[idx][rep]
                # encode orientation in read id: rc reads get id + R
                cand_read.append(rr + (R if is_rc else 0))
                cand_pos.append(diag)
            if not cand_read:
                return
            if len(self.jtid) == 0:
                return  # no candidate junctions to count against
            cr = np.concatenate(cand_read).astype(np.int64)
            cp = np.concatenate(cand_pos).astype(np.int64)
            # dedupe (read+orient, diag)
            order = np.lexsort((cp, cr))
            cr, cp = cr[order], cp[order]
            keep = np.ones(len(cr), bool)
            keep[1:] = (cr[1:] != cr[:-1]) | (cp[1:] != cp[:-1])
            cr, cp = cr[keep], cp[keep]
            ori = (cr >= R).astype(np.int8)
            ri = np.where(ori == 1, cr - R, cr)
            L = lens[ri]
            nbuf = len(self.buf)
            # validity: bounds + segment-respecting
            valid = (cp >= 0) & (cp + L <= nbuf)
            in_genome = cp < self.gn
            valid &= ~(in_genome & (cp + L > self.gn))
            # genomic placements must stay within one chromosome
            goffs = self.genome.offsets
            gt0 = np.searchsorted(goffs, np.clip(cp, 0, None),
                                  side="right") - 1
            gt0 = np.clip(gt0, 0, len(goffs) - 2)
            valid &= ~(in_genome & (cp + L > goffs[gt0 + 1]))
            cpos = cp - self.gn
            c0 = np.searchsorted(self.ctx_offs, np.maximum(cpos, 0),
                                 side="right") - 1
            c0 = np.clip(c0, 0, max(len(self.ctx_offs) - 2, 0))
            ctx_ok = in_genome | (cpos + L <= self.ctx_offs[c0 + 1])
            valid &= ctx_ok
            cr, cp, ori, ri, L, c0, in_genome = (
                cr[valid], cp[valid], ori[valid], ri[valid], L[valid],
                c0[valid], in_genome[valid])
            if not len(cr):
                return
        with span("lr2rmats.sr.verify"):
            # Hamming verify: rc candidates compare the rc read buffer
            count("lr2rmats.sr.candidates", len(cr))
            mm = np.empty(len(cr), np.int32)
            if self._dev_verifier is not None or lib is not None:
                # unified reads buffer: fwd ++ rc; segment R+j is the rc of
                # read R-1-j, so rc of read i = segment 2R-1-i.  ONE shared
                # construction — the device and native verifiers must stay
                # bit-equal, so they must read identical candidate layouts.
                comb = np.concatenate([fwd, rc_all])
                comb_off = np.empty(2 * R + 1, np.int64)
                comb_off[: R + 1] = offs
                comb_off[R + 1:] = (2 * total -
                                    offs[R - 1:: -1].astype(np.int64))
                # read id for candidate: fwd -> ri, rc -> index of rc segment
                rc_seg = 2 * R - 1 - ri
                rid_comb = np.where(ori == 1, rc_seg, ri).astype(np.int32)
            if self._dev_verifier is not None:
                mm = self._dev_verifier.verify(comb, comb_off, rid_comb, cp)
            elif lib is not None:
                lib.hamming_pairs_c(self.buf, nbuf, comb,
                                    np.ascontiguousarray(comb_off),
                                    np.ascontiguousarray(rid_comb),
                                    np.ascontiguousarray(cp), len(cp), mm)
            else:
                for t in range(len(cr)):
                    if ori[t]:
                        seg = rc_all[total - int(offs[ri[t] + 1]):
                                     total - int(offs[ri[t]])]
                    else:
                        seg = fwd[int(offs[ri[t]]): int(offs[ri[t] + 1])]
                    mm[t] = int(np.sum(self.buf[cp[t]: cp[t] + L[t]] != seg))
            max_mm = (p.max_mm_frac * L).astype(np.int32)
            okmm = mm <= max_mm
            cr, cp, ori, ri, L, c0, in_genome, mm = (
                cr[okmm], cp[okmm], ori[okmm], ri[okmm], L[okmm], c0[okmm],
                in_genome[okmm], mm[okmm])
            if not len(cr):
                return None
        with span("lr2rmats.sr.best"):
            # group by read (both orientations together)
            order = np.lexsort((cp, ori, ri))
            cr, cp, ori, ri, L, c0, in_genome, mm = (
                x[order] for x in (cr, cp, ori, ri, L, c0, in_genome, mm))
            grp_start = np.concatenate(
                [[0], np.nonzero(ri[1:] != ri[:-1])[0] + 1])
            best_mm = np.minimum.reduceat(mm, grp_start)
            best_per_cand = np.repeat(
                best_mm, np.diff(np.concatenate([grp_start, [len(ri)]])))
            is_best = mm == best_per_cand
            off_in_ctx = cp - self.gn - self.ctx_offs[c0]
            left = self.ctx_left_len[c0].astype(np.int64)
            lpart = left - off_in_ctx
            rpart = off_in_ctx + L - left
            return (ri, cp, ori, L, c0, in_genome, mm, grp_start, is_best,
                    lpart, rpart)

    def result(self) -> SJTable:
        n = len(self.jtid)
        strand = np.zeros(n, np.int8)
        motif = np.zeros(n, np.int8)
        for j in range(n):
            s, m = intron_motif_of(self.genome, int(self.jtid[j]),
                                   int(self.jdon[j]), int(self.jacc[j]))
            strand[j], motif[j] = s, m
        uniq_c, multi_c, max_over = (self.uniq_c.copy(),
                                     self.multi_c.copy(),
                                     self.max_over.copy())
        if self._dev_counts is not None:
            du, dm, do = self._dev_counts.fetch()
            uniq_c += du
            multi_c += dm
            np.maximum(max_over, do, out=max_over)
        t = SJTable(
            tid=self.jtid.copy(), don=self.jdon.copy(), acc=self.jacc.copy(),
            strand=strand, motif=motif, is_anno=self.janno.astype(np.int8),
            uniq_c=uniq_c, multi_c=multi_c, max_over=max_over,
        )
        return t.sort()


class TorchJunctionCounter(JunctionCounter):
    """JunctionCounter with the device backend on `device` (the kernel on
    a card, the plain versions on the CPU)."""

    def __init__(self, genome: Genome, tid: np.ndarray, don: np.ndarray,
                 acc: np.ndarray, is_anno: np.ndarray,
                 params: Optional[SJCountParams] = None, device="cuda"):
        super().__init__(genome, tid, don, acc, is_anno, params,
                         backend="device", device=device)


def count_junction_support(genome: Genome, gtf_sets: List[Transcripts],
                           read_sets,
                           params: Optional[SJCountParams] = None,
                           device="cuda") -> SJTable:
    """One-call junction support counting (STAR star_map role).

    read_sets: list whose items are either a SeqSet (single-end,
    README.md:169-175) or a (SeqSet, SeqSet) mate pair — pairs are counted
    with proper-pair gating (count_pairs_batched).  The counter's backend
    is chosen by LR2RMATS_DEVICE_SJCOUNT (TorchJunctionCounter on
    `device`, else the host counter)."""
    log("sjcount", "building junction contexts ...")
    tid, don, acc, anno = gather_junctions(gtf_sets)
    if os.environ.get("LR2RMATS_DEVICE_SJCOUNT"):
        jc = TorchJunctionCounter(genome, tid, don, acc, anno, params,
                                  device=device)
    else:
        jc = JunctionCounter(genome, tid, don, acc, anno, params,
                             backend="host")
    log("sjcount", "placing %d read sets (%s) ...", len(read_sets),
        jc.backend)
    for rs in read_sets:
        if isinstance(rs, tuple):
            jc.count_pairs_batched(rs[0], rs[1])
        else:
            jc.count_seqset_batched(rs)
    log("sjcount", "junction support counting done.")
    return jc.result()
