"""The plain reference of short-read junction counting, in PyTorch.

It imports nothing of the program.  It takes the genome, the planted
introns and the read pairs that the harness generated, and counts them by
the semantics the configuration states (the STAR SJ.out.tab role of the
program's `JunctionCounter.count_pairs_batched`):

  1. each junction has a context: the `overhang` bases before its intron
     and the `overhang` bases after it; the search buffer is the genome
     followed by every context;
  2. every `seed_k`-mer of the buffer that lies inside the genome (a k-mer
     across two chromosomes included) or inside one context is a seed
     target;
  3. each read, in both orientations, takes `seeds_per_read` seeds evenly
     spaced from its first to its last k-mer; a seed whose k-mer occurs
     more than `cap_per_seed` times in the buffer is dropped; each hit
     proposes the placement hit - seed offset;
  4. a placement counts when it lies inside one chromosome or inside one
     context, with at most floor(max_mm_frac * length) mismatches; each
     read keeps the placements with its fewest mismatches (both
     orientations together);
  5. a pair is concordant through a pair of kept placements, one per mate,
     on opposite orientations of one chromosome, whose anchors (the
     placement, or the junction's donor for a context) lie at most
     `max_mates_gap` apart; a kept placement participates when it is in such
     a pair;
  6. a mate's participating context placement that crosses its junction by
     at least `min_overhang` on both sides counts for that junction, unless
     the mate also has a participating genomic placement; it counts as
     unique when the pair is concordant in exactly one way, else as multi;
     max_over is the largest min(left, right) crossing seen.

`count` returns (uniq, multi, max_over) for one batch of pairs.  With
`proper_pairs=False` it breaks the configuration's proper-pair guarantee:
every kept placement counts as if it were in a concordant pair (the
control).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_COMP = torch.tensor([3, 2, 1, 0], dtype=torch.uint8)


@dataclass
class Params:
    overhang: int
    min_overhang: int
    seed_k: int
    max_mm_frac: float
    seeds_per_read: int
    max_mates_gap: int
    cap_per_seed: int


def _kmer_hash(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[..., n - k + 1] int64 2-bit packing of every k-mer of the last
    dimension."""
    n = codes.shape[-1] - k + 1
    h = torch.zeros((*codes.shape[:-1], max(n, 0)), dtype=torch.int64,
                    device=codes.device)
    for j in range(k):
        h = h * 4 + codes[..., j: j + n].to(torch.int64)
    return h


class Reference:
    def __init__(self, codes: np.ndarray, offsets: np.ndarray,
                 introns: np.ndarray, p: Params, device):
        """codes / offsets: the genome; introns: [n, 3] (chrom, donor,
        acceptor), the intron's first and last base, 1-based."""
        dev = torch.device(device)
        self.p, self.dev = p, dev
        self.gn = int(offsets[-1])
        self.goffs = torch.from_numpy(offsets.astype(np.int64)).to(dev)
        OH = p.overhang
        parts, left = [], []
        for c, d, a in introns.tolist():
            o, L = int(offsets[c]), int(offsets[c + 1] - offsets[c])
            lseg = codes[o + max(0, d - OH - 1): o + min(L, d - 1)]
            rseg = codes[o + max(0, a): o + min(L, a + OH)]
            parts.append(np.concatenate([lseg, rseg]))
            left.append(len(lseg))
        ctx_offs = np.zeros(len(parts) + 1, np.int64)
        np.cumsum([len(x) for x in parts], out=ctx_offs[1:])
        buf = np.concatenate([codes, *parts])
        self.buf = torch.from_numpy(buf).to(dev)
        self.ctx_offs = torch.from_numpy(ctx_offs).to(dev)
        self.left = torch.from_numpy(np.asarray(left, np.int64)).to(dev)
        self.jchrom = torch.from_numpy(introns[:, 0].copy()).to(dev)
        self.janchor = self.goffs[self.jchrom] + torch.from_numpy(
            introns[:, 1].copy()).to(dev)
        self.nj = len(introns)
        # seed targets: k-mers wholly inside the genome (across its
        # chromosomes' borders too) or wholly inside one context
        k = p.seed_k
        h = _kmer_hash(self.buf, k)
        start = torch.arange(len(h), device=dev)
        seg_ends = torch.cat([self.goffs[-1:], self.gn + self.ctx_offs[1:]])
        seg = torch.searchsorted(seg_ends, start, right=True)
        ok = start + k <= seg_ends[seg.clamp(max=len(seg_ends) - 1)]
        h, pos = h[ok], start[ok]
        order = torch.argsort(h)
        self.th, self.tpos = h[order], pos[order]
        del h, start, seg, ok, order

    def _place(self, reads: torch.Tensor):
        """Kept placements of reads [R, L], one row each: (read,
        orientation, chromosome, anchor, context id, crosses its junction,
        overhang, genomic)."""
        p, dev = self.p, self.dev
        R, L = reads.shape
        k = p.seed_k
        both = torch.cat([reads, _COMP.to(dev)[reads.long()].flip(1)])
        fr = np.linspace(0, 1, p.seeds_per_read)
        offs = torch.tensor(np.maximum((fr * (L - k)).astype(np.int64), 0),
                            device=dev)
        h = _kmer_hash(both, k)[:, offs]                 # [2R, S]
        lo = torch.searchsorted(self.th, h)
        hi = torch.searchsorted(self.th, h, right=True)
        cnt = hi - lo
        cnt = torch.where((cnt > 0) & (cnt <= p.cap_per_seed), cnt, 0)
        flat_cnt = cnt.reshape(-1)
        q = torch.repeat_interleave(
            torch.arange(flat_cnt.numel(), device=dev), flat_cnt)
        first = torch.cumsum(flat_cnt, 0) - flat_cnt
        hit = lo.reshape(-1)[q] + (torch.arange(q.numel(), device=dev)
                                   - first[q])
        rid = q // offs.numel()                          # row of `both`
        cp = self.tpos[hit] - offs[q % offs.numel()]
        key = torch.unique(rid * (len(self.buf) + L + 1) + (cp + L))
        rid = key // (len(self.buf) + L + 1)
        cp = key % (len(self.buf) + L + 1) - L
        # inside one chromosome or one context
        inside = (cp >= 0) & (cp + L <= len(self.buf))
        cps = cp.clamp(0, len(self.buf) - 1)
        genomic = cps < self.gn
        chrom = torch.searchsorted(self.goffs, cps, right=True) - 1
        chrom = chrom.clamp(0, len(self.goffs) - 2)
        c0 = torch.searchsorted(self.ctx_offs, (cps - self.gn).clamp(min=0),
                                right=True) - 1
        c0 = c0.clamp(0, max(self.nj - 1, 0))
        end_ok = torch.where(genomic, cp + L <= self.goffs[chrom + 1],
                             cp - self.gn + L <= self.ctx_offs[c0 + 1])
        keep = inside & end_ok
        rid, cp, genomic, chrom, c0 = (x[keep] for x in
                                       (rid, cp, genomic, chrom, c0))
        win = self.buf[cp[:, None] + torch.arange(L, device=dev)]
        mm = (win != both[rid]).sum(1)
        ok = mm <= int(p.max_mm_frac * L)
        rid, cp, genomic, chrom, c0, mm = (x[ok] for x in
                                           (rid, cp, genomic, chrom, c0, mm))
        read = rid % R
        best = torch.full((R,), 1 << 30, dtype=mm.dtype, device=dev)
        best = best.scatter_reduce(0, read, mm, "amin")
        b = mm == best[read]
        read, ori, cp, genomic, chrom, c0 = (
            read[b], (rid[b] >= R).to(torch.int8), cp[b], genomic[b],
            chrom[b], c0[b])
        off = cp - self.gn - self.ctx_offs[c0]
        lpart = self.left[c0] - off
        rpart = off + L - self.left[c0]
        crossing = (~genomic & (lpart >= p.min_overhang) &
                    (rpart >= p.min_overhang))
        chrom = torch.where(genomic, chrom, self.jchrom[c0])
        anchor = torch.where(genomic, cp, self.janchor[c0])
        over = torch.minimum(lpart, rpart)
        return read, ori, chrom, anchor, c0, crossing, over, genomic

    def count(self, r1: np.ndarray, r2: np.ndarray,
              proper_pairs: bool = True):
        """(uniq, multi, max_over) int64 arrays over the junctions for one
        batch of pairs r1, r2 [R, L] uint8."""
        dev = self.dev
        R = r1.shape[0]
        m1 = self._place(torch.from_numpy(r1).to(dev))
        m2 = self._place(torch.from_numpy(r2).to(dev))
        # every combination of a mate-1 and a mate-2 placement of a pair
        n2 = torch.bincount(m2[0], minlength=R)
        o2 = torch.argsort(m2[0], stable=True)
        first2 = torch.cumsum(n2, 0) - n2
        reps = n2[m1[0]]
        i1 = torch.repeat_interleave(torch.arange(len(m1[0]), device=dev),
                                     reps)
        start = torch.cumsum(reps, 0) - reps
        i2 = o2[first2[m1[0][i1]] + torch.arange(len(i1), device=dev)
                - start[i1]]
        conc = ((m1[1][i1] != m2[1][i2]) & (m1[2][i1] == m2[2][i2]) &
                ((m1[3][i1] - m2[3][i2]).abs() <= self.p.max_mates_gap))
        n_conc = torch.zeros(R, dtype=torch.int64, device=dev)
        n_conc.index_add_(0, m1[0][i1], conc.to(torch.int64))
        uniq = torch.zeros(self.nj, dtype=torch.int64, device=dev)
        multi = torch.zeros_like(uniq)
        over = torch.zeros_like(uniq)
        for m, idx in ((m1, i1), (m2, i2)):
            read, _, _, _, c0, crossing, ov, genomic = m
            part = torch.zeros(len(read), dtype=torch.bool, device=dev)
            if proper_pairs:
                part[idx[conc]] = True
                ok_pair = n_conc[read] >= 1
            else:
                part[:] = True
                ok_pair = torch.ones_like(part)
            tie = torch.zeros(R, dtype=torch.bool, device=dev)
            tie[read[part & genomic]] = True
            sel = part & crossing & ok_pair & ~tie[read]
            u = (n_conc[read] == 1) if proper_pairs else (
                torch.bincount(read, minlength=R)[read] == 1)
            c = c0[sel]
            one = torch.ones_like(c)
            uniq.index_add_(0, c[u[sel]], one[u[sel]])
            multi.index_add_(0, c[~u[sel]], one[~u[sel]])
            over.scatter_reduce_(0, c, ov[sel], "amax")
        return tuple(x.cpu().numpy() for x in (uniq, multi, over))
