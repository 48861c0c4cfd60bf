"""The pass-2 classify tail at 100k novel reads a sample: host code only.

The counterpart of scripts/bench_pass2_tail.py.  Run from the repository
root:

    python -m lr2rmats_tpu_torch.scripts.bench_pass2_tail [--out F]
    python -m lr2rmats_tpu_torch.scripts.bench_pass2_tail --anno 100 \\
        --reads 2000

It times `transcript/classify.py` `check_trans` with `split_trans=True,
full_level=3` (update-gtf `-s`) on the reference's generated input, seed 5:
N_ANNO (2000) multi-exon transcripts tiled along one chromosome, and
N_READS (100000) reads, each an annotated chain with one donor moved 5-29
bases left (a novel junction); half of the novel junctions are in the SJ
table (the supported ones), the other half take the split path; every
annotated junction is supported.

No kernel and no card is involved: the classify runs on the host in every
configuration of the port, so this entry point runs without a card too.
Its line names the card (nvidia-smi's name and power limit) when the
machine has one, and the host's core count.  Prints the reference's text
on stderr and one JSON line on stdout, also to `--out` when one is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_ANNO = 2000
N_READS = 100_000
SEED = 5


def make_input(n_anno: int = N_ANNO, n_reads: int = N_READS,
               seed: int = SEED):
    """(reads, anno, sj) of the reference's generator."""
    from ..io.sj import SJTable
    from ..transcript.model import Transcripts
    rng = np.random.default_rng(seed)
    anno = Transcripts()
    base = 1000
    anno_chains = []
    for i in range(n_anno):
        n = int(rng.integers(3, 9))
        pos = base
        s, e = [], []
        for _ in range(n):
            el = int(rng.integers(80, 300))
            s.append(pos)
            e.append(pos + el)
            pos += el + int(rng.integers(100, 2000))
        anno_chains.append((s, e))
        anno.append(0, False, s, e, gene_id=f"G{i}", gene_name=f"G{i}",
                    trans_id=f"T{i}", trans_name=f"T{i}", init_novel=False)
        base = pos + 3000

    reads = Transcripts()
    sj_rows = set()
    order = np.sort(rng.integers(0, n_anno, n_reads))
    for ri, ai in enumerate(order.tolist()):
        s, e = anno_chains[ai]
        s2, e2 = list(s), list(e)
        k = int(rng.integers(0, len(s2) - 1))
        supported = bool(rng.random() < 0.5)
        e2[k] = e2[k] - int(rng.integers(5, 30))
        if supported:
            sj_rows.add((0, e2[k] + 1, s2[k + 1] - 1, 5, 0))
        reads.append(0, False, s2, e2, trans_id=f"r{ri}", trans_name=f"r{ri}")
    for s, e in anno_chains:
        for j in range(len(s) - 1):
            sj_rows.add((0, e[j] + 1, s[j + 1] - 1, 9, 1))
    rows = np.asarray(sorted(sj_rows), np.int64)
    sj = SJTable(tid=rows[:, 0].astype(np.int32),
                 don=rows[:, 1].astype(np.int32),
                 acc=rows[:, 2].astype(np.int32),
                 strand=np.zeros(len(rows), np.int8),
                 motif=np.zeros(len(rows), np.int8),
                 is_anno=np.zeros(len(rows), np.int8),
                 uniq_c=rows[:, 3].astype(np.int32),
                 multi_c=rows[:, 4].astype(np.int32))
    return reads, anno, sj


def classify(reads, anno, sj):
    """check_trans with -s, full level 3; returns (updated, known, novel,
    unrecognised, wall seconds)."""
    from ..transcript.classify import check_trans
    from ..transcript.model import Transcripts, UpdateGtfParams
    ugp = UpdateGtfParams(split_trans=True, full_level=3)
    upd, kn, nv, un = (Transcripts() for _ in range(4))
    t0 = time.perf_counter()
    check_trans(reads, anno, sj, ugp, upd, kn, nv, un)
    return upd, kn, nv, un, time.perf_counter() - t0


def run(n_anno: int = N_ANNO, n_reads: int = N_READS) -> dict:
    """The generated input through `classify`; the counts and the wall."""
    reads, anno, sj = make_input(n_anno, n_reads)
    upd, kn, nv, un, wall = classify(reads, anno, sj)
    return {"n_reads": n_reads, "n_anno": n_anno, "sj": sj.n,
            "wall_s": wall, "reads_per_s": n_reads / wall, "known": kn.n,
            "novel": nv.n, "unrecog": un.n, "updated": upd.n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--anno", type=int, default=N_ANNO,
                    help=f"annotated transcripts (default {N_ANNO})")
    ap.add_argument("--reads", type=int, default=N_READS,
                    help=f"reads (default {N_READS})")
    ap.add_argument("--out", help="write the result JSON here")
    args = ap.parse_args(argv)
    from ..diag.measure import host_detail
    r = run(args.anno, args.reads)
    print(f"reads={r['n_reads']} anno={r['n_anno']} sj={r['sj']} "
          f"wall={r['wall_s']:.2f}s known={r['known']} novel={r['novel']} "
          f"unrecog={r['unrecog']} updated={r['updated']} "
          f"({r['reads_per_s']:.0f} reads/s)", file=sys.stderr)
    out = {"metric": "pass2_classify_tail", **host_detail(), **r}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
