"""Synthetic workloads of the port, without the reference package.

Two generators, each giving the same bytes from the same seed as the
reference repository's own:

  * the bench workload (bench.py `build_genome`, `simulate_reads`,
    `accuracy_vs_truth`, `_pack`): one random chromosome with non-
    overlapping planted genes and long cDNA reads over them, clean or with
    the ONT-like error profile, and the accuracy of primary alignments
    against the planted truth;
  * the pipeline dataset (scripts/simulate.py): genome.fa, anno.gtf
    (multi-gene, multi-isoform), long reads from annotated and novel
    isoforms, and paired short reads from the same transcript pool:

        python -m lr2rmats_tpu_torch.synth --out DIR [--genome-mb 12]
            [--genes 200] [--long-reads 20000] [--short-pairs 50000]
            [--long-err 0.03] [--short-err 0.005] [--seed 7]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from .io.fasta import Genome, SeqSet, decode_seq, revcomp


def build_genome(n_bases: int, rng) -> Genome:
    """One uniformly random chromosome "chrB" of n_bases."""
    codes = rng.integers(0, 4, n_bases).astype(np.uint8)
    return Genome(["chrB"], codes, np.array([0, n_bases], np.int64))


def simulate_reads(genome: Genome, n_reads: int, rng, err: float = 0.03,
                   profile: Optional[str] = None):
    """Simulated cDNA reads: 2-6 exons of 150-600 bp, introns 200-20k.

    Gene structures are planted first in non-overlapping genome slots,
    then reads are generated (several per gene when the genome is too
    small for n_reads genes).  Mutates genome.codes (motifs, repeats).

    profile=None  : uniform substitutions at rate `err`, all introns
                    canonical GT..AG
    profile="ont" : ONT-like 2.5% sub + 1.5% del + 1% ins, 96% GT..AG /
                    2% GC..AG / 2% AT..AC motifs, plus 200 copies of 1-4 kb
                    segments pasted elsewhere (repeat content)

    Returns (reads, truths): code arrays and each read's exon list."""
    minor_frac = 0.04 if profile == "ont" else 0.0
    L = len(genome.codes)
    if profile == "ont":
        # paste repeats before planting genes so motifs survive
        for _ in range(200):
            sl = int(rng.integers(1000, 4000))
            src = int(rng.integers(0, L - sl))
            dst = int(rng.integers(0, L - sl))
            genome.codes[dst: dst + sl] = genome.codes[src: src + sl]
    genes = []
    pos = 1000
    while len(genes) < n_reads:
        pos += int(rng.integers(200, 2000))
        n_exons = int(rng.integers(2, 7))
        parts = []
        okg = True
        for e in range(n_exons):
            elen = int(rng.integers(150, 600))
            if pos + elen + 20_100 > L:
                okg = False
                break
            parts.append((pos, pos + elen))
            pos += elen
            if e < n_exons - 1:
                r = rng.random()
                if r >= minor_frac:
                    genome.codes[pos], genome.codes[pos + 1] = 2, 3   # GT
                    endm = (0, 2)                                      # AG
                elif r < minor_frac / 2:
                    genome.codes[pos], genome.codes[pos + 1] = 2, 1   # GC
                    endm = (0, 2)                                      # AG
                else:                                                  # AT..AC
                    genome.codes[pos], genome.codes[pos + 1] = 0, 3
                    endm = (0, 1)
                ilen = int(rng.integers(200, 20_000))
                pos += ilen
                genome.codes[pos - 2], genome.codes[pos - 1] = endm
        if not okg:
            break
        if len(parts) >= 2:
            genes.append(parts)
    reads = []
    truths = []
    for i in range(n_reads):
        parts = genes[i % len(genes)]
        read = np.concatenate([genome.codes[a:b] for a, b in parts]).copy()
        if profile == "ont":
            mask = rng.random(len(read)) < 0.025
            read[mask] = (read[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
            # indels (deletion-biased, like ONT homopolymer errors)
            keep = rng.random(len(read)) >= 0.015
            read = read[keep]
            ins = np.nonzero(rng.random(len(read)) < 0.01)[0]
            if len(ins):
                read = np.insert(read, ins,
                                 rng.integers(0, 4, len(ins)).astype(np.uint8))
        else:
            mask = rng.random(len(read)) < err
            read[mask] = (read[mask] + rng.integers(1, 4, int(mask.sum()))) % 4
        if rng.random() < 0.5:
            read = revcomp(read)
        reads.append(read)
        truths.append(parts)
    return reads, truths


def accuracy_vs_truth(truths, names, primary):
    """(n exact exon chains, splice-site TPs, total true sites) of the
    primary records `primary` (qname -> AlnRec) against `truths`."""
    from .transcript.exon_chain import gen_exons
    exact = 0
    site_tp = site_n = 0
    for i, parts in enumerate(truths):
        true_sites = []
        for (a1, b1), (a2, b2) in zip(parts[:-1], parts[1:]):
            true_sites += [b1, a2 + 1]          # 1-based donor end / acc start
        site_n += len(true_sites)
        r = primary.get(names[i])
        if r is None:
            continue
        es, ee, _ = gen_exons(r, 3, 3, 50)
        got = []
        for j in range(len(es) - 1):
            got += [int(ee[j]), int(es[j + 1])]
        if got == true_sites:
            exact += 1
        site_tp += len(set(got) & set(true_sites))
    return exact, site_tp, site_n


def pack_seqset(reads: List[np.ndarray], names: List[str]) -> SeqSet:
    """The reads as one SeqSet (bench.py `_pack`)."""
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    return SeqSet(names, np.concatenate(reads), offs)


def simulate_dataset(out: str, genome_mb: float = 12.0, genes: int = 200,
                     long_reads: int = 20000, short_pairs: int = 50000,
                     long_err: float = 0.03, short_err: float = 0.005,
                     seed: int = 7) -> str:
    """Write the pipeline dataset of scripts/simulate.py into `out`:
    genome.fa, anno.gtf, long.fa, short_1.fa, short_2.fa.  Returns a
    one-line summary."""
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    n = int(genome_mb * 1e6)
    codes = rng.integers(0, 4, n).astype(np.uint8)

    gene_list = []
    pos = 50_000
    stride = (n - 100_000) // genes
    for gi in range(genes):
        gstart = pos + int(rng.integers(0, stride // 4))
        n_ex = int(rng.integers(3, 9))
        exons = []
        e = gstart
        for xi in range(n_ex):
            elen = int(rng.integers(120, 500))
            exons.append((e, e + elen))
            e += elen
            if xi < n_ex - 1:
                codes[e] = 2                      # GT..AG
                codes[e + 1] = 3
                ilen = int(rng.integers(100, 4000))
                e += ilen
                codes[e - 2] = 0
                codes[e - 1] = 2
        strand = "+" if rng.random() < 0.5 else "-"
        # isoforms: full + an exon skip; one novel isoform with an internal
        # donor shifted 40 bp left (a novel splice site)
        isoforms = [("T%d.1" % gi, exons, True)]
        if n_ex >= 4:
            skip = list(range(n_ex))
            skip.remove(int(rng.integers(1, n_ex - 1)))
            isoforms.append(("T%d.2" % gi, [exons[i] for i in skip], True))
        if n_ex >= 3:
            nov = list(exons)
            a, b = nov[1]
            if b - a > 160:
                nov[1] = (a, b - 40)
                codes[b - 40] = 2
                codes[b - 39] = 3
                isoforms.append(("T%d.novel" % gi, nov, False))
        gene_list.append((f"G{gi}", strand, exons, isoforms))
        pos += stride

    with open(os.path.join(out, "genome.fa"), "w") as f:
        f.write(">chrSim\n")
        seq = decode_seq(codes)
        for i in range(0, len(seq), 60):
            f.write(seq[i: i + 60] + "\n")

    with open(os.path.join(out, "anno.gtf"), "w") as f:
        for gid, strand, exons, isoforms in gene_list:
            for tid, iex, annotated in isoforms:
                if not annotated:
                    continue
                attrs = (f'gene_id "{gid}"; transcript_id "{tid}"; '
                         f'gene_name "{gid}N"; transcript_name "{tid}N";')
                f.write(f"chrSim\tsim\ttranscript\t{iex[0][0]+1}\t{iex[-1][1]}"
                        f"\t.\t{strand}\t.\t{attrs}\n")
                for a, b in iex:
                    f.write(f"chrSim\tsim\texon\t{a+1}\t{b}\t.\t{strand}\t.\t"
                            f"{attrs}\n")

    pool = []
    for gid, strand, exons, isoforms in gene_list:
        for tid, iex, annotated in isoforms:
            tx = np.concatenate([codes[a:b] for a, b in iex])
            pool.append((tid, tx, strand))

    def mutate(read, err):
        m = rng.random(len(read)) < err
        read = read.copy()
        read[m] = (read[m] + rng.integers(1, 4, int(m.sum()))) % 4
        return read

    with open(os.path.join(out, "long.fa"), "w") as f:
        for i in range(long_reads):
            tid, tx, strand = pool[int(rng.integers(0, len(pool)))]
            read = mutate(tx, long_err)
            if strand == "-" or rng.random() < 0.5:
                read = revcomp(read)
            f.write(f">lr{i}_{tid}\n{decode_seq(read)}\n")

    with open(os.path.join(out, "short_1.fa"), "w") as f1, \
            open(os.path.join(out, "short_2.fa"), "w") as f2:
        for i in range(short_pairs):
            tid, tx, strand = pool[int(rng.integers(0, len(pool)))]
            if len(tx) < 260:
                continue
            frag = int(rng.integers(220, min(400, len(tx))))
            off = int(rng.integers(0, len(tx) - frag + 1))
            r1 = mutate(tx[off: off + 101], short_err)
            r2 = revcomp(mutate(tx[off + frag - 101: off + frag], short_err))
            f1.write(f">p{i}/1\n{decode_seq(r1)}\n")
            f2.write(f">p{i}/2\n{decode_seq(r2)}\n")

    return (f"wrote dataset to {out}: genome {genome_mb}Mb, {genes} genes, "
            f"{len(pool)} transcripts, {long_reads} long reads, "
            f"{short_pairs} short pairs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the pipeline dataset of scripts/simulate.py")
    ap.add_argument("--out", required=True)
    ap.add_argument("--genome-mb", type=float, default=12.0)
    ap.add_argument("--genes", type=int, default=200)
    ap.add_argument("--long-reads", type=int, default=20000)
    ap.add_argument("--short-pairs", type=int, default=50000)
    ap.add_argument("--long-err", type=float, default=0.03)
    ap.add_argument("--short-err", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args(argv)
    print(simulate_dataset(a.out, a.genome_mb, a.genes, a.long_reads,
                           a.short_pairs, a.long_err, a.short_err, a.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
