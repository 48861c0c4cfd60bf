"""Short-read junction counter at chr21 scale, on the card.

The counterpart of scripts/bench_sjcount.py.  Run from the repository
root:

    python -m lr2rmats_tpu_torch.scripts.bench_sjcount [--reads 2000000]
        [--genome-mb 46.7] [--genes 1000] [--read-len 100]
        [--batch 200000] [--backend device|host] [--check]
        [--device cuda|cpu]

Simulates a chr21-sized genome (seed 42) with planted three-exon genes,
generates paired-end short reads from their transcripts, and counts them
with the batched paired counter (`JunctionCounter.count_pairs_batched`).
The default backend is `device`: the Hamming verify on csrc/hamming.cu and
the count scatters as torch ops on `--device` (cuda by default; on the CPU
their plain versions); `host` is the native host path.  With --check the
same pairs also go through a host-backend counter, and the unique and
multi count arrays must be equal (exit 1 otherwise).

Prints one JSON line: short reads counted per second (the count wall
only, each batch ending in a synchronise of the card), junction recall,
the unique count total, the hamming kernel's launches and CUDA-event time,
and the card (nvidia-smi's name and power limit).  Without a card and
without --device cpu it exits 2 and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

SEED = 42


def simulate(genome_mb: float, genes: int, rng):
    """(genome, junction donor / acceptor arrays, transcripts): a random
    chromosome "chr21" with `genes` planted three-exon genes, canonical
    GT..AG introns of 300-5000 bases."""
    from ..io.fasta import Genome
    n = int(genome_mb * 1e6)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    genome = Genome(["chr21"], codes, np.array([0, n], np.int64))
    jd, ja, tx = [], [], []
    gap = n // (genes + 2)
    for g in range(genes):
        pos = 10_000 + g * gap
        exons = []
        for e in range(3):
            elen = int(rng.integers(150, 400))
            exons.append((pos, pos + elen))
            pos += elen
            if e < 2:
                genome.codes[pos], genome.codes[pos + 1] = 2, 3
                don = pos
                pos += int(rng.integers(300, 5000))
                genome.codes[pos - 2], genome.codes[pos - 1] = 0, 2
                jd.append(don + 1)          # 1-based intron first base
                ja.append(pos)              # 1-based intron last base
        tx.append(np.concatenate([genome.codes[a:b] for a, b in exons]))
    return genome, np.asarray(jd, np.int32), np.asarray(ja, np.int32), tx


def simulate_pairs(tx, b: int, L: int, rng):
    """b read pairs of length L: a 2L+20..450-base fragment of a random
    transcript, mate 1 its start, mate 2 the reverse complement of its
    end, 0.5% substitutions each."""
    from ..io.fasta import SeqSet, revcomp
    r1 = np.empty((b, L), np.uint8)
    r2 = np.empty((b, L), np.uint8)
    ti = rng.integers(0, len(tx), b)
    for i in range(b):
        t = tx[ti[i]]
        flen = int(rng.integers(2 * L + 20, min(450, len(t))))
        off = int(rng.integers(0, len(t) - flen + 1))
        frag = t[off: off + flen]
        r1[i] = frag[:L]
        r2[i] = revcomp(frag[-L:])
    err = rng.random((b, L)) < 0.005
    r1[err] = (r1[err] + 1) % 4
    err = rng.random((b, L)) < 0.005
    r2[err] = (r2[err] + 1) % 4
    offs = np.arange(b + 1, dtype=np.int64) * L
    return (SeqSet([f"a{i}" for i in range(b)], r1.reshape(-1), offs),
            SeqSet([f"b{i}" for i in range(b)], r2.reshape(-1), offs))


def counts(jc):
    """(uniq, multi) of a counter, the device tables included."""
    uc, mc = jc.uniq_c, jc.multi_c
    if jc._dev_counts is not None:
        du, dm, _ = jc._dev_counts.fetch()
        uc, mc = uc + du, mc + dm
    return uc, mc


def run(pairs: int = 2_000_000, genome_mb: float = 46.7, genes: int = 1000,
        read_len: int = 100, batch: int = 200_000, backend: str = "device",
        device="cuda", check: bool = False) -> dict:
    """The bench's measurement; raises GuardError when --check finds the
    host backend's counts differ."""
    import torch

    from ..device import resolve_device
    from ..diag.measure import GuardError, device_detail
    from ..junctions.sjcount import JunctionCounter, SJCountParams
    from ..ops import _build
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    genome, jd, ja, tx = simulate(genome_mb, genes, rng)
    jt = np.zeros(len(jd), np.int32)
    setup_s = time.perf_counter() - t0

    def counter(bk):
        return JunctionCounter(genome, jt, jd, ja, np.ones(len(jt), np.int32),
                               SJCountParams(), backend=bk, device=dev)

    t0 = time.perf_counter()
    jc = counter(backend)
    ref = counter("host") if check else None
    init_s = time.perf_counter() - t0
    print(f"# genome {genome_mb} Mb, {len(jt)} junctions, setup "
          f"{setup_s:.1f} s, counter init {init_s:.1f} s", file=sys.stderr)
    t_cnt = t_ref = 0.0
    done = 0
    _build.reset_launches()
    with _build.timing() as kernel_ms:
        while done < pairs:
            b = min(batch, pairs - done)
            s1, s2 = simulate_pairs(tx, b, read_len, rng)
            t1 = time.perf_counter()
            jc.count_pairs_batched(s1, s2)
            if cuda:
                torch.cuda.synchronize(dev)
            t_cnt += time.perf_counter() - t1
            if ref is not None:
                t1 = time.perf_counter()
                ref.count_pairs_batched(s1, s2)
                t_ref += time.perf_counter() - t1
            done += b
            print(f"#   {done}/{pairs} pairs, count {t_cnt:.1f} s "
                  f"({done * 2 / t_cnt / 1e3:.0f}k reads/s)", file=sys.stderr)
    launches = dict(_build.LAUNCHES)
    uc, mc = counts(jc)
    if ref is not None:
        ru, rm = counts(ref)
        if not (np.array_equal(uc, ru) and np.array_equal(mc, rm)):
            raise GuardError(
                f"{jc.backend} counts differ from the host backend's: uniq "
                f"{int(uc.sum())} vs {int(ru.sum())}, multi {int(mc.sum())} "
                f"vs {int(rm.sum())}, {int((uc != ru).sum())} + "
                f"{int((mc != rm).sum())} junctions differ")
    supported = int(np.sum(uc + mc > 0))
    return {
        "metric": ("short_reads_counted_per_sec" if cuda or backend == "host"
                   else "short_reads_counted_per_sec_on_cpu"),
        "value": 2 * pairs / t_cnt,
        "unit": "reads/s",
        "detail": {
            **device_detail(dev),
            "pairs": pairs, "genome_mb": genome_mb, "genes": genes,
            "read_len": read_len, "batch": batch, "backend": jc.backend,
            "count_wall_s": t_cnt, "setup_s": setup_s,
            "counter_init_s": init_s,
            "junctions": len(jt),
            "junction_recall": round(supported / len(jt), 4),
            "uniq_counts_total": int(uc.sum()),
            "multi_counts_total": int(mc.sum()),
            "hamming_launches": launches["hamming"],
            "kernel_ms": kernel_ms,
            "checked_against_host": check,
            "host_count_wall_s": t_ref if check else None,
        }}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=2_000_000,
                    help="number of read PAIRS")
    ap.add_argument("--genome-mb", type=float, default=46.7)
    ap.add_argument("--genes", type=int, default=1000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--batch", type=int, default=200_000)
    ap.add_argument("--backend", choices=("device", "host"),
                    default="device",
                    help="device (default) = csrc/hamming.cu and the count "
                         "scatters on --device; host = the native path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--check", action="store_true",
                    help="also count the same pairs on the host backend; "
                         "the count arrays must be equal")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..diag.measure import GuardError
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_sjcount: {e}", file=sys.stderr)
        return 2
    try:
        line = run(args.reads, args.genome_mb, args.genes, args.read_len,
                   args.batch, args.backend, args.device, args.check)
    except GuardError as e:
        print(f"bench_sjcount: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
