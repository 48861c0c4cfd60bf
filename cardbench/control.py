"""The controls of `correct`: the reference put in the program's place in a
lower precision, or with a stated guarantee broken, at a cell's own size.

    python3 -m cardbench.control --workload <cell> --seeds 1,2,3

For an `align` cell, the reference aligner (ref_align.sw_align) runs in
bfloat16, the nearest precision below the configuration's float32
scores, on the reads that a run scores, and its alignments, written as
SAM records on the genome, are judged by ref_align.judge against the
cell's limits, as the program's are.  For an
`sr_count` cell, the reference counts each pooled batch once with the
configuration's proper-pair guarantee broken, and `count_diffs` is taken
against the reference's own counts.  The program does not run.  Prints
one JSON line per seed.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import gen, ref_align, ref_sjcount, run
from .entries import align


def align_control(spec: dict, seed: int, device, dtype=torch.bfloat16
                  ) -> dict:
    """The reference aligner in `dtype` in the aligner's place, on the
    reads that a run scores (SCORED of two pooled calls, drawn from the
    seed), its alignments written as SAM and judged by ref_align.judge
    against the cell's limits."""
    e = align.Entry(spec["config"], {**spec["traffic"], "pool_calls": 2},
                    seed, device)
    e.generate()
    calls = e.judged_calls([(0, b""), (1, b"")])
    sample = align.score_sample([len(c.names) for c in calls], seed)
    names = [f"s{n}".encode() for n in range(len(sample))]
    reads = [calls[k].reads[i] for k, i in sample]
    rc = np.array([calls[k].rc[i] for k, i in sample])
    genes = [calls[k].genes[i] for k, i in sample]
    alns = ref_align.sw_align(
        [gen.COMP[r[::-1]] if f else r for r, f in zip(reads, rc)],
        [e.dep.transcript(g) for g in genes], device, dtype)
    sam = ref_align.control_sam(names, reads, rc, genes, e.dep, alns)
    res = ref_align.judge([ref_align.Judged(sam, names, reads, rc, genes)],
                          e.dep, [(0, i) for i in range(len(names))],
                          device)
    nums = ref_align.numbers(res, spec["limits"])
    return {**{n: v for n, v, _ in nums},
            "correct": run.correct(nums),
            "reads": res["reads_judged"]}


def sr_control(spec: dict, seed: int, device) -> dict:
    cfg = spec["config"]
    c = cfg["counter"]
    dep = gen.build_deployment(cfg, seed)
    ref = ref_sjcount.Reference(
        dep.codes, dep.offsets, dep.introns(),
        ref_sjcount.Params(**{k: c[k] for k in (
            "overhang", "min_overhang", "seed_k", "max_mm_frac",
            "seeds_per_read", "max_mates_gap", "cap_per_seed")}), device)
    diff = None
    sums = [0, 0]
    for r1, r2 in gen.short_pair_batches(dep, spec["traffic"], seed):
        good = ref.count(r1, r2)
        bad = ref.count(r1, r2, proper_pairs=False)
        d = np.zeros(len(good[0]), bool)
        for a, b in zip(good, bad):
            d |= a != b
        diff = d if diff is None else diff | d
        sums[0] += int(good[0].sum())
        sums[1] += int(bad[0].sum())
    return {"count_diffs": int(diff.sum()), "uniq_total": sums[0],
            "uniq_total_control": sums[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    kind = spec["traffic"]["entry"]
    fn = {"align": align_control, "sr_count": sr_control}[kind]
    dev = torch.device(args.device)
    for s in args.seeds.split(","):
        out = fn(spec, int(s), dev)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "control": out, "limits": spec["limits"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
