"""Failure analysis of the ONT bench profile, on the card.

The counterpart of scripts/analyze_ont_failures.py.  Run from the
repository root:

    python -m lr2rmats_tpu_torch.scripts.analyze_ont_failures [--out F]
    BENCH_READS=300 BENCH_GENOME_MB=2 \\
        python -m lr2rmats_tpu_torch.scripts.analyze_ont_failures --device cpu

The workload is bench.py's (synth.py, the same bytes): seed 123, a
BENCH_GENOME_MB (20) Mb genome, BENCH_READS (6000) ONT-profile reads.  They
go through `TorchBatchAligner` on the device in batches of 512; every read
whose primary record's exon chain (`gen_exons(r, 3, 3, 50)`) is not exactly
the planted one falls into the first category that fits, in this order:
`unaligned` (no primary record), `wrong_locus` (no overlap with the truth
widened by 10 kb), `missed_junction` / `extra_junction` (fewer / more
splice sites), else `slide_le2`, `slide_le10` or `slide_gt10` by the
largest site shift.  The reference's text (the counts, then up to 8 reads a
category) goes to stderr.

The guard: the same seqset through the port's host backend (`BatchAligner`,
same index, same batches) must give the same SAM bytes; a difference raises
GuardError and exits 1.  Prints one JSON line with the counts, the walls,
the kernel launches and the card (nvidia-smi's name and power limit), and
writes it to `--out` when one is given.  Without a card and without
--device cpu it exits 2 and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .. import synth
from ..bench import workload

N_READS = int(os.environ.get("BENCH_READS", "6000"))
GENOME_MB = float(os.environ.get("BENCH_GENOME_MB", "20"))
BATCH = 512


def categorize(rb, truths, names) -> dict:
    """Category -> [(read index, None or (true sites, found sites))] of
    every read whose exon chain is not the planted one, in the order the
    reference fills them."""
    from ..transcript.exon_chain import gen_exons
    primary = {r.qname: r for r in rb.to_alnrecs() if not (r.flag & 0x100)}
    cats: dict = {}
    for i, parts in enumerate(truths):
        true_sites = []
        for (_, b1), (a2, _) in zip(parts[:-1], parts[1:]):
            true_sites += [b1, a2 + 1]
        r = primary.get(names[i])
        if r is None:
            cats.setdefault("unaligned", []).append((i, None))
            continue
        es, ee, _ = gen_exons(r, 3, 3, 50)
        got = []
        for j in range(len(es) - 1):
            got += [int(ee[j]), int(es[j + 1])]
        if got == true_sites:
            continue
        t0, t1 = parts[0][0], parts[-1][1]
        if not (es[0] < t1 + 10000 and ee[-1] > t0 - 10000):
            cat = "wrong_locus"
        elif len(got) < len(true_sites):
            cat = "missed_junction"
        elif len(got) > len(true_sites):
            cat = "extra_junction"
        else:
            mx = max(abs(g - t) for g, t in zip(got, true_sites))
            cat = ("slide_le2" if mx <= 2 else
                   "slide_le10" if mx <= 10 else "slide_gt10")
        cats.setdefault(cat, []).append((i, (true_sites, got)))
    return cats


def report(cats: dict, n_reads: int) -> str:
    """The reference's printed text: the inexact count, the categories
    (ordered as the reference orders them) and up to 8 reads of each."""
    total_bad = sum(len(v) for v in cats.values())
    out = [f"reads={n_reads} inexact={total_bad} "
           f"({1 - total_bad / n_reads:.4f} exact)"]
    for cat, items in sorted(cats.items(), key=lambda kv: -len(kv[0])):
        out.append(f"  {cat}: {len(items)}")
    for cat, items in cats.items():
        out.append(f"--- {cat} ---")
        for i, tg in items[:8]:
            if tg is None:
                out.append(f"  read{i}: unaligned")
                continue
            t, g = tg
            out.append(f"  read{i} nexon_t={len(t) // 2 + 1}")
            if len(t) == len(g):
                out.append(f"    deltas {[gg - tt for gg, tt in zip(g, t)]}")
            else:
                out.append(f"    true {t}")
                out.append(f"    got  {g}")
    return "\n".join(out) + "\n"


def analyze(n_reads: int = None, device="cuda", genome_mb: float = None):
    """The workload through the device path and the host backend; raises
    GuardError unless their SAMs are the same bytes.  Returns (categories,
    detail)."""
    from ..align.batch import BatchAligner, TorchBatchAligner
    from ..device import resolve_device
    from ..diag.measure import GuardError, align_pass, first_diff
    dev = resolve_device(device)
    n_reads = N_READS if n_reads is None else n_reads
    genome_mb = GENOME_MB if genome_mb is None else genome_mb
    genome, reads, truths, names = workload(genome_mb, n_reads, "ont")
    seqset = synth.pack_seqset(reads, names)
    al = TorchBatchAligner(genome, device=dev)
    p = align_pass(al, seqset, dev, batch_size=BATCH)
    host = BatchAligner(genome, index=al.index)
    t0 = time.perf_counter()
    sam_host = host.align_seqset_packed(seqset, batch_size=BATCH).emit_sam(
        host.refs)
    host_wall = time.perf_counter() - t0
    al.close()
    host.close()
    if p["sam"] != sam_host:
        raise GuardError("the device path's SAM differs from the host "
                         "backend's: " + first_diff(p["sam"], sam_host))
    cats = categorize(p["rb"], truths, names)
    inexact = sum(len(v) for v in cats.values())
    detail = {"n_reads": len(reads), "genome_mb": genome_mb, "batch": BATCH,
              "inexact": inexact,
              "exact_exon_chain_frac": 1 - inexact / len(reads),
              "categories": {k: len(v) for k, v in cats.items()},
              "wall_s": p["wall_s"], "host_backend_wall_s": host_wall,
              "sam_identical_to_host_backend": True,
              "launches": p["launches"], "kernel_ms": p["kernel_ms"],
              "peak_device_mb": p["peak_device_mb"]}
    return cats, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--out", help="write the result JSON here")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..diag.measure import GuardError, device_detail
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"analyze_ont_failures: {e}", file=sys.stderr)
        return 2
    try:
        cats, detail = analyze(N_READS, dev, GENOME_MB)
    except GuardError as e:
        print(f"analyze_ont_failures: guard failed: {e}", file=sys.stderr)
        return 1
    sys.stderr.write(report(cats, detail["n_reads"]))
    out = {"metric": "ont_failure_categories", **device_detail(dev),
           **detail}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
