"""Accuracy of the ONT-profile bench workload over five seeds, on the card.

The counterpart of scripts/ont_accuracy_sweep.py.  Run from the repository
root:

    python -m lr2rmats_tpu_torch.scripts.ont_accuracy_sweep [--out F]
    python -m lr2rmats_tpu_torch.scripts.ont_accuracy_sweep --device cpu

For each of the seeds 123-127: bench.py's generator (synth.py) builds a
SWEEP_GENOME_MB (20) Mb genome and SWEEP_READS (1500) ONT-profile reads;
the reads go through `TorchBatchAligner` on the device (the card path; the
reference swept its host backend) in batches of 512, then through the
port's host backend (`BatchAligner`), and the two SAMs must be the same
bytes.  Each seed's exact-exon-chain fraction and splice-site recall must
equal the repository's ONT_ACCURACY.json when the sizes are the file's; at
other sizes nothing is compared with it.  Any difference exits 1.

Prints one JSON line, naming the card (nvidia-smi's name and power limit),
with every seed's result (each also on stderr as it finishes).  It reads
ONT_ACCURACY.json and never writes it: the line goes to `--out` as well
when one is given, and nowhere else.  Without a card and without --device
cpu it exits 2 and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .. import synth
from ..bench import accuracy, workload

SEEDS = (123, 124, 125, 126, 127)
N_READS = int(os.environ.get("SWEEP_READS", "1500"))
GENOME_MB = float(os.environ.get("SWEEP_GENOME_MB", "20"))
BATCH = 512
EXPECT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "ONT_ACCURACY.json")


def one_seed(seed: int, device="cuda", n_reads: int = None,
             genome_mb: float = None) -> dict:
    """One seed through the device path and the host backend; raises
    GuardError unless their SAMs are the same bytes."""
    from ..align.batch import BatchAligner, TorchBatchAligner
    from ..device import resolve_device
    from ..diag.measure import GuardError, align_pass, first_diff
    dev = resolve_device(device)
    n_reads = N_READS if n_reads is None else n_reads
    genome_mb = GENOME_MB if genome_mb is None else genome_mb
    genome, reads, truths, names = workload(genome_mb, n_reads, "ont",
                                            seed=seed)
    names = [f"ont{i}" for i in range(len(reads))]
    seqset = synth.pack_seqset(reads, names)
    al = TorchBatchAligner(genome, device=dev)
    p = align_pass(al, seqset, dev, batch_size=BATCH)
    host = BatchAligner(genome, index=al.index)
    t0 = time.perf_counter()
    rb_host = host.align_seqset_packed(seqset, batch_size=BATCH)
    sam_host = rb_host.emit_sam(host.refs)
    host_wall = time.perf_counter() - t0
    al.close()
    host.close()
    if p["sam"] != sam_host:
        raise GuardError(f"seed {seed}: the device path's SAM differs from "
                         "the host backend's: "
                         + first_diff(p["sam"], sam_host))
    acc = accuracy(p["rb"], truths, names)
    n = len(reads)
    return {
        "seed": seed,
        "exact_exon_chain_frac": round(acc["exact"] / n, 4),
        "splice_site_recall": round(acc["site_tp"] / max(acc["site_n"], 1),
                                    4),
        "aligned_frac": round(acc["primaries"] / n, 4),
        "wall_s": p["wall_s"],
        "host_backend_wall_s": host_wall,
        "sam_identical_to_host_backend": True,
        "launches": p["launches"],
        "kernel_ms": p["kernel_ms"],
        "peak_device_mb": p["peak_device_mb"],
    }


def expected(path: str, n_reads: int, genome_mb: float):
    """Seed -> (exact exon chain, splice-site recall) of the recorded
    sweep at `path`; None when its sizes are not these."""
    with open(path) as f:
        doc = json.load(f)
    if doc["n_reads_per_seed"] != n_reads or doc["genome_mb"] != genome_mb:
        return None
    return {r["seed"]: (r["exact_exon_chain_frac"], r["splice_site_recall"])
            for r in doc["per_seed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--out", help="write the summary JSON here")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..diag.measure import GuardError, device_detail
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ont_accuracy_sweep: {e}", file=sys.stderr)
        return 2
    want = expected(EXPECT, N_READS, GENOME_MB)
    rows, bad = [], []
    try:
        for seed in SEEDS:
            r = one_seed(seed, dev)
            if want is not None:
                r["expected"] = list(want[seed])
                if (r["exact_exon_chain_frac"],
                        r["splice_site_recall"]) != want[seed]:
                    bad.append(seed)
            print(json.dumps(r), file=sys.stderr, flush=True)
            rows.append(r)
    except GuardError as e:
        print(f"ont_accuracy_sweep: guard failed: {e}", file=sys.stderr)
        return 1
    fracs = [r["exact_exon_chain_frac"] for r in rows]
    out = {
        "metric": "ont_accuracy_sweep", **device_detail(dev),
        "n_reads_per_seed": N_READS, "genome_mb": GENOME_MB,
        "batch": BATCH, "per_seed": rows,
        "min": min(fracs), "max": max(fracs),
        "mean": round(sum(fracs) / len(fracs), 4),
        "compared_with": "ONT_ACCURACY.json" if want is not None else None,
        "equal_to_recorded": not bad if want is not None else None,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out), flush=True)
    if bad:
        print(f"ont_accuracy_sweep: seeds {bad} differ from {EXPECT}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
