"""The yardstick's generators: genomes with planted genes, long reads and
short read pairs, all from a seed.

Frozen copies, extended where a configuration needs it, of the generators
of `lr2rmats_tpu_torch/synth.py` (`build_genome`, `simulate_reads`,
`pack_seqset`) and of `lr2rmats_tpu_torch/scripts/bench_sjcount.py`
(`simulate_pairs`).  The extensions:

  * several chromosomes, each planted on its own (`plan_genes`);
  * a gene model given by the configuration's numbers: exon counts, exon and
    intron lengths, gaps between genes, and a share of single-exon genes;
  * a fixed gene layout: the sizes and places of the genes come from the
    configuration's `layout_seed`, so every run measures the same sizes;
    `--seed` draws the sequence, the pasted repeats, the read errors, the
    strands and the order of the reads;
  * reads drawn gene by gene, a fixed number a gene (`long_read_calls`),
    made in bulk with numpy instead of one read at a time.

Codes are 0..3 for A, C, G, T, as in the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

COMP = np.array([3, 2, 1, 0, 4], np.uint8)
# (donor, acceptor) dinucleotides as codes: GT..AG, GC..AG, AT..AC
MOTIFS = (((2, 3), (0, 2)), ((2, 1), (0, 2)), ((0, 3), (0, 1)))


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use (`stream`) of one seed; any
    whole number is a seed."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


@dataclass
class Gene:
    chrom: int                      # chromosome index
    exons: List[Tuple[int, int]]    # chromosome-local [start, end), sorted


@dataclass
class Deployment:
    names: List[str]
    codes: np.ndarray               # uint8, every chromosome in turn
    offsets: np.ndarray             # int64 [n_chrom + 1]
    genes: List[Gene]
    # [n, 3] int64 (chrom, start, end): both copies of each pasted repeat
    repeats: np.ndarray = None

    def transcript(self, g: Gene) -> np.ndarray:
        o = int(self.offsets[g.chrom])
        return np.concatenate([self.codes[o + a: o + b] for a, b in g.exons])

    def repeated(self, g: Gene) -> bool:
        """Whether an exon of `g` overlaps a pasted repeat copy: its reads
        then have a second true place."""
        r = self.repeats
        if r is None or not len(r):
            return False
        r = r[r[:, 0] == g.chrom]
        return any(bool(np.any((r[:, 1] < b) & (r[:, 2] > a)))
                   for a, b in g.exons)

    def introns(self) -> np.ndarray:
        """[n, 3] int64 (chrom, donor, acceptor): each planted intron's
        first and last base, 1-based and chromosome-local."""
        rows = [(g.chrom, b1 + 1, a2)
                for g in self.genes
                for (_, b1), (a2, _) in zip(g.exons[:-1], g.exons[1:])]
        return np.asarray(rows, np.int64).reshape(-1, 3)


def _draw(rng, lo_hi) -> int:
    lo, hi = lo_hi
    return int(rng.integers(lo, hi))


def plan_genes(lengths: List[int], model: dict, layout_seed: int):
    """The gene layout of a configuration: for each chromosome, genes one
    after another from `model["start"]`, each after a gap drawn from
    `model["gap"]`, with an exon count from `model["exons"]` (a share
    `model["single_exon_share"]` of genes has one exon), exon lengths from
    `model["exon_len"]` and intron lengths from `model["intron_len"]`
    (synth.py's loop: stop at the first gene that would come within
    `model["end_pad"]` of the chromosome's end).  Returns the genes and,
    for each intron, the index of its motif in MOTIFS."""
    rng = np.random.default_rng(layout_seed)
    share = model.get("single_exon_share", 0.0)
    minor = model["minor_motif_share"]
    genes, motifs = [], []
    for chrom, L in enumerate(lengths):
        pos = model["start"]
        while True:
            pos += _draw(rng, model["gap"])
            n_ex = (1 if rng.random() < share else
                    _draw(rng, model["exons"]))
            parts, mine = [], []
            ok = True
            for e in range(n_ex):
                elen = _draw(rng, model["exon_len"])
                if pos + elen + model["end_pad"] > L:
                    ok = False
                    break
                parts.append((pos, pos + elen))
                pos += elen
                if e < n_ex - 1:
                    r = rng.random()
                    mine.append(0 if r >= minor else
                                1 if r < minor / 2 else 2)
                    pos += _draw(rng, model["intron_len"])
            if not ok:
                break
            genes.append(Gene(chrom, parts))
            motifs += mine
    return genes, motifs


def build_deployment(cfg: dict, seed: int) -> Deployment:
    """The genome of a configuration from `seed`: uniformly random
    chromosomes of `cfg["chromosomes"]`'s lengths, `repeats` pasted copies
    of segments of `repeat_len` bases within each chromosome (before the
    motifs are written, as synth.py does), then the planned genes' splice
    motifs."""
    names = [c["name"] for c in cfg["chromosomes"]]
    lengths = [int(c["length"]) for c in cfg["chromosomes"]]
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    rng = rng_of(seed, 0)
    codes = rng.integers(0, 4, int(offsets[-1]), dtype=np.uint8)
    total = int(offsets[-1])
    n_rep = int(cfg["profile"]["repeats"])
    copies = []
    lo, hi = cfg["profile"]["repeat_len"]
    for _ in range(n_rep):
        sl = int(rng.integers(lo, hi))
        # a chromosome in proportion to its length, then two places in it
        c = int(np.searchsorted(offsets, rng.integers(0, total),
                                side="right") - 1)
        L = lengths[c]
        if L <= sl:
            continue
        src = int(offsets[c]) + int(rng.integers(0, L - sl))
        dst = int(offsets[c]) + int(rng.integers(0, L - sl))
        codes[dst: dst + sl] = codes[src: src + sl]
        o = int(offsets[c])
        copies += [(c, src - o, src - o + sl), (c, dst - o, dst - o + sl)]
    genes, motifs = plan_genes(lengths, cfg["gene_model"],
                               int(cfg["layout_seed"]))
    k = 0
    for g in genes:
        o = int(offsets[g.chrom])
        for (_, b1), (a2, _) in zip(g.exons[:-1], g.exons[1:]):
            don, acc = MOTIFS[motifs[k]]
            k += 1
            codes[o + b1], codes[o + b1 + 1] = don
            codes[o + a2 - 2], codes[o + a2 - 1] = acc
    return Deployment(names, codes, offsets, genes,
                      np.asarray(copies, np.int64).reshape(-1, 3))


def ragged_revcomp(flat: np.ndarray, offs: np.ndarray,
                   flip: np.ndarray) -> np.ndarray:
    """`flat` with every segment i where flip[i] reverse-complemented."""
    n = len(offs) - 1
    lens = np.diff(offs)
    seg = np.repeat(np.arange(n), lens)
    idx = np.arange(len(flat))
    rev = offs[seg] + offs[seg + 1] - 1 - idx
    f = flip[seg]
    out = flat.copy()
    out[f] = COMP[flat[rev[f]]]
    return out


def long_reads(dep: Deployment, gene_ids: np.ndarray, profile: dict,
               rng: np.random.Generator):
    """One read per entry of gene_ids: the gene's whole transcript with the
    profile's errors (`sub`, `del`, `ins` rates, as synth.py's ONT profile
    applies them: substitutions, then deletions, then insertions of random
    bases), reverse-complemented with probability 1/2.

    Returns (codes, offsets, rc): the reads in one flat uint8 buffer, their
    offsets, and whether each read is the reverse complement of its
    transcript."""
    tx = [dep.transcript(dep.genes[int(g)]) for g in gene_ids]
    lens = np.fromiter((len(t) for t in tx), np.int64, len(tx))
    flat = np.concatenate(tx) if tx else np.zeros(0, np.uint8)
    seg = np.repeat(np.arange(len(tx)), lens)
    m = rng.random(len(flat)) < profile["sub"]
    flat[m] = (flat[m] + rng.integers(1, 4, int(m.sum()))) % 4
    keep = rng.random(len(flat)) >= profile["del"]
    flat, seg = flat[keep], seg[keep]
    ins = np.nonzero(rng.random(len(flat)) < profile["ins"])[0]
    if len(ins):
        flat = np.insert(flat, ins,
                         rng.integers(0, 4, len(ins)).astype(np.uint8))
        seg = np.insert(seg, ins, seg[ins])
    offs = np.zeros(len(tx) + 1, np.int64)
    np.cumsum(np.bincount(seg, minlength=len(tx)), out=offs[1:])
    rc = rng.random(len(tx)) < 0.5
    return ragged_revcomp(flat, offs, rc), offs, rc


def long_read_calls(dep: Deployment, per: int, profile: dict,
                    traffic: dict, seed: int):
    """The pool of long-read calls of a traffic mix: `pool_calls` calls of
    `per` reads with the error profile `profile`.  With `genes_per_call` set, call c draws its
    reads from the genes c*genes_per_call ... round the planted set, each
    gene per / genes_per_call times; without it, the reads of call c
    go to the genes c*per + i in turn, round the set.
    The reads of a call are shuffled.  Returns a list of (gene_ids, codes,
    offsets, rc), one per call."""
    n_genes = len(dep.genes)
    gpc = traffic.get("genes_per_call")
    rng = rng_of(seed, 1)
    calls = []
    for c in range(int(traffic["pool_calls"])):
        if gpc:
            g = (c * gpc + np.arange(gpc)) % n_genes
            gene_ids = np.repeat(g, per // gpc)
        else:
            gene_ids = (c * per + np.arange(per)) % n_genes
        gene_ids = rng.permutation(gene_ids)
        calls.append((gene_ids, *long_reads(dep, gene_ids, profile, rng)))
    return calls


def short_pairs(dep: Deployment, n: int, L: int, frag_max: int,
                sub: float, rng: np.random.Generator):
    """n read pairs of length L (bench_sjcount.py `simulate_pairs`): a
    fragment of 2L+20 .. min(frag_max, transcript length) bases of a random
    planted transcript, mate 1 its start, mate 2 the reverse complement of
    its end, substitutions at rate `sub` each (to the next code, as there).
    Returns (r1, r2) as [n, L] uint8."""
    tx = [dep.transcript(g) for g in dep.genes]
    tlen = np.array([len(t) for t in tx], np.int64)
    if tlen.min() < 2 * L + 21:
        raise ValueError("a planted transcript is shorter than a fragment")
    toff = np.zeros(len(tx) + 1, np.int64)
    np.cumsum(tlen, out=toff[1:])
    flat = np.concatenate(tx)
    ti = rng.integers(0, len(tx), n)
    hi = np.minimum(frag_max, tlen[ti])
    flen = rng.integers(2 * L + 20, hi)
    off = (rng.random(n) * (tlen[ti] - flen + 1)).astype(np.int64)
    start = toff[ti] + off
    j = np.arange(L)
    r1 = flat[start[:, None] + j]
    r2 = COMP[flat[(start + flen - 1)[:, None] - j]]
    for r in (r1, r2):
        err = rng.random((n, L)) < sub
        r[err] = (r[err] + 1) % 4
    return r1, r2


def short_pair_batches(dep: Deployment, traffic: dict, seed: int):
    """The pool of short-read batches of a traffic mix: `pool_batches`
    batches of `pairs_per_batch` pairs of `read_len`-base reads."""
    rng = rng_of(seed, 2)
    return [short_pairs(dep, int(traffic["pairs_per_batch"]),
                        int(traffic["read_len"]), int(traffic["frag_max"]),
                        float(traffic["sub"]), rng)
            for _ in range(int(traffic["pool_batches"]))]
