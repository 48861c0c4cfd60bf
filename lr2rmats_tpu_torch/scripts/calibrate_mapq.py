"""MAPQ calibration against simulation truth, on the card.

The counterpart of scripts/calibrate_mapq.py.  Run from the repository
root:

    python -m lr2rmats_tpu_torch.scripts.calibrate_mapq [--reads N] [--out F]
    python -m lr2rmats_tpu_torch.scripts.calibrate_mapq --device cpu \\
        --reads 200 --genome-mb 2

For each profile (clean with seed 5, ONT with seed 6): bench.py's generator
(synth.py, the same bytes) builds a GENOME_MB (20) Mb genome and N (20000)
reads; the reads go through `TorchBatchAligner` on the device with
`record_margins` on, which records the raw score margin 1 - s2/s1 of every
primary record.  Each primary record becomes a row (qname, mapq, nh,
correct), correct when its reference span (CIGAR ops M, D and N from its
position) overlaps the read's true source span, as the reference builds
them.  `table` bins the rows of both profiles by margin (BINS, reads with
nh > 1 only) into the empirical error and phred -10 log10(max(err,
1/(n+1))) of each bin, beside the unique reads' error.

The guard: the same seqset through the port's host backend (`BatchAligner`,
same index, margins recorded) must give the same SAM bytes, record the same
qnames, and give every read a margin within MARGIN_ATOL of the card's (the
card chains in float32, the host in float64) and in the same bin.  A
difference raises GuardError and exits 1.

Prints one JSON line naming the card (nvidia-smi's name and power limit):
the table, each profile's walls, launches and peak card memory, and, when
the size is the recorded one (20000 reads a profile on 20 Mb), whether the
table equals MAPQ_CALIBRATION.json (`equals_recorded`) and the bins that
differ.  It reads MAPQ_CALIBRATION.json and never writes it: the line goes
to `--out` as well when one is given, and nowhere else.  Without a card and
without --device cpu it exits 2 and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .. import synth
from ..bench import workload

PROFILES = ((None, 5), ("ont", 6))          # (error profile, seed)
N_READS = 20000
GENOME_MB = 20.0
BINS = (0.0, 0.01, 0.02, 0.05, 0.10, 0.15, 0.25, 0.40, 0.60, 1.01)
MARGIN_ATOL = 1e-6
# the CIGAR ops that consume the reference: M, D, N
REF_OPS = (0, 2, 3)
EXPECT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "MAPQ_CALIBRATION.json")


def bin_of(margin):
    """Index of the bin [BINS[i], BINS[i + 1]) holding `margin`; None
    outside them (or for None)."""
    if margin is None:
        return None
    for i, (lo, hi) in enumerate(zip(BINS[:-1], BINS[1:])):
        if lo <= margin < hi:
            return i
    return None


def rows_of(rb, truths, names):
    """(qname, mapq, nh, correct) of every primary record of `rb`
    (scripts/calibrate_mapq.py:61-79)."""
    span = {}
    for name, parts in zip(names, truths):
        span[name] = (min(a for a, _ in parts), max(b for _, b in parts))
    out = []
    for t in range(rb.n):
        if rb.flag[t] & 0x100:
            continue
        qn = rb.qname[t]
        lo, hi = span[qn]
        cig = rb.cig_buf[rb.cig_offs[t]: rb.cig_offs[t + 1]]
        span_lo = int(rb.pos[t])
        span_hi = span_lo + int(((cig >> 4) * np.isin(cig & 0xF,
                                                       REF_OPS)).sum())
        out.append((qn, int(rb.mapq[t]), int(rb.nh[t]),
                    span_lo < hi and span_hi > lo))
    return out


def _phred(err: float, n: int) -> float:
    return round(float(-10 * np.log10(max(err, 1.0 / (n + 1)))), 1)


def table(rows) -> dict:
    """The reference's table over rows {"mapq", "nh", "correct",
    "margin"}: per margin bin (nh > 1 only; empty bins left out) n, err
    and phred; and the unique reads' (nh == 1) n, err and phred."""
    bins = []
    for i, (lo, hi) in enumerate(zip(BINS[:-1], BINS[1:])):
        sel = [r for r in rows if r["nh"] > 1 and bin_of(r["margin"]) == i]
        if not sel:
            continue
        err = 1.0 - sum(r["correct"] for r in sel) / len(sel)
        bins.append({"margin_lo": lo, "margin_hi": hi, "n": len(sel),
                     "err": round(err, 5), "phred": _phred(err, len(sel))})
    uniq = [r for r in rows if r["nh"] == 1]
    uerr = 1.0 - sum(r["correct"] for r in uniq) / max(len(uniq), 1)
    return {"unique": {"n": len(uniq), "err": round(uerr, 6),
                       "phred": _phred(uerr, len(uniq))},
            "margin_bins": bins}


def _guard_margins(tag: str, card: dict, host: dict) -> None:
    from ..diag.measure import GuardError
    if set(card) != set(host):
        only = sorted(set(card) ^ set(host))
        raise GuardError(f"{tag}: the card and the host backend record "
                         f"margins of different reads ({len(only)}, e.g. "
                         f"{only[:5]})")
    for qn, m in card.items():
        h = host[qn]
        if abs(m - h) > MARGIN_ATOL or bin_of(m) != bin_of(h):
            raise GuardError(f"{tag}: {qn}'s margin {m!r} on the card, "
                             f"{h!r} on the host backend")


def run_profile(profile, n_reads: int = N_READS, seed: int = 5,
                device="cuda", genome_mb: float = GENOME_MB):
    """One profile through the device path with margins recorded, then
    through the host backend; raises GuardError unless the SAM bytes and
    the margins agree.  Returns (rows, margins, detail)."""
    from ..align.batch import BatchAligner, TorchBatchAligner
    from ..device import resolve_device
    from ..diag.measure import GuardError, align_pass, first_diff
    dev = resolve_device(device)
    tag = profile or "clean"
    genome, reads, truths, _ = workload(genome_mb, n_reads, profile, seed)
    names = [f"r{i}" for i in range(len(reads))]
    seqset = synth.pack_seqset(reads, names)
    al = TorchBatchAligner(genome, device=dev)
    al.record_margins = True
    p = align_pass(al, seqset, dev)
    host = BatchAligner(genome, index=al.index)
    host.record_margins = True
    t0 = time.perf_counter()
    sam_host = host.align_seqset_packed(seqset).emit_sam(host.refs)
    host_wall = time.perf_counter() - t0
    al.close()
    host.close()
    if p["sam"] != sam_host:
        raise GuardError(f"{tag}: the device path's SAM differs from the "
                         "host backend's: " + first_diff(p["sam"], sam_host))
    _guard_margins(tag, al._mapq_margins, host._mapq_margins)
    rows = rows_of(p["rb"], truths, names)
    detail = {"profile": tag, "seed": seed, "n_reads": len(reads),
              "primaries": len(rows), "wall_s": p["wall_s"],
              "host_backend_wall_s": host_wall,
              "sam_identical_to_host_backend": True,
              "margins_recorded": len(al._mapq_margins),
              "launches": p["launches"], "kernel_ms": p["kernel_ms"],
              "peak_device_mb": p["peak_device_mb"]}
    return rows, dict(al._mapq_margins), detail


def recorded_diff(path: str, got: dict, n_reads: int, genome_mb: float):
    """None when the size is not the recorded file's; else the bins (and
    "unique") of `got` that differ from the file's."""
    with open(path) as f:
        doc = json.load(f)
    if doc["n_per_profile"] != n_reads or genome_mb != GENOME_MB:
        return None
    diff = [] if got["unique"] == doc["unique"] else ["unique"]
    want = {(b["margin_lo"], b["margin_hi"]): b for b in doc["margin_bins"]}
    have = {(b["margin_lo"], b["margin_hi"]): b for b in got["margin_bins"]}
    diff += [list(k) for k in sorted(set(want) | set(have))
             if want.get(k) != have.get(k)]
    return diff


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--reads", type=int, default=N_READS,
                    help=f"reads a profile (default {N_READS})")
    ap.add_argument("--genome-mb", type=float, default=GENOME_MB,
                    help=f"genome size in Mb (default {GENOME_MB:g})")
    ap.add_argument("--out", help="write the result JSON here")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..diag.measure import GuardError, device_detail
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"calibrate_mapq: {e}", file=sys.stderr)
        return 2
    rows, profiles = [], []
    try:
        for profile, seed in PROFILES:
            res, margins, detail = run_profile(profile, args.reads, seed,
                                               dev, args.genome_mb)
            rows += [{"profile": profile or "clean", "mapq": mq, "nh": nh,
                      "correct": bool(ok), "margin": margins.get(qn)}
                     for qn, mq, nh, ok in res]
            print(json.dumps(detail), file=sys.stderr, flush=True)
            profiles.append(detail)
    except GuardError as e:
        print(f"calibrate_mapq: guard failed: {e}", file=sys.stderr)
        return 1
    got = table(rows)
    diff = recorded_diff(EXPECT, got, args.reads, args.genome_mb)
    out = {"metric": "mapq_calibration", **device_detail(dev),
           "n_per_profile": args.reads, "genome_mb": args.genome_mb, **got,
           "profiles": profiles,
           "compared_with": "MAPQ_CALIBRATION.json" if diff is not None
           else None,
           "equals_recorded": diff == [] if diff is not None else None,
           "bins_differing": diff}
    if diff:
        print(f"calibrate_mapq: bins {diff} differ from {EXPECT}",
              file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
