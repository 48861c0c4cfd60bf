"""GRCh38-scale dry run of the port: the memory and scale envelope on the
card.

The counterpart of scripts/dryrun_grch38.py.  Run from the repository
root:

    python -m lr2rmats_tpu_torch.scripts.dryrun_grch38 [--out F]
    python -m lr2rmats_tpu_torch.scripts.dryrun_grch38 --shards 2 [--out F]
    python -m lr2rmats_tpu_torch.scripts.dryrun_grch38 --device cpu

A synthetic genome of DRYRUN_CHROMS (24) chromosomes of DRYRUN_CHROM_MB
(129) Mb each (3.1 Gbp, seed 7, generated in 64 MB chunks) and
DRYRUN_READS (50000) clean-profile multi-exon reads (bench.py's generator;
reads whose gene crosses a chromosome boundary are dropped).  Global
coordinates pass 2^31 past the 17th chromosome.

Single-process arm: the native minimizer index over the whole genome, then
`TorchBatchAligner(device=...)` with the device seed lookup (the sorted
hash table resident on the card as int32) aligns the reads in batches of
1536; the lookup's (lo, hi) are first checked against
`MinimizerIndex.lookup` on a sample of queries.  The same reads then go
through the port's host backend on the same index, and the two SAMs must
be the same bytes.  Records peak host RSS (after the card pass and at the
end), peak card memory (`torch.cuda.max_memory_allocated`), the walls of
the index build and of both passes, and the accuracy against the planted
truth.

Sharded arm (--shards N): N processes of one torch.distributed group (gloo
for the payloads; they share one card) each build only their hash range
of the index (parallel/shard_index.py) and align their round-robin share
of the reads in lockstep batches through the collective lookup, on the
device path and then on the host backend, whose records must be equal.

Prints one JSON line naming the card (nvidia-smi's name and power limit);
--out writes it to a file as well, and nothing else is written.  Any
mismatch exits 1; without a card and without --device cpu it exits 2 and
prints no result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import subprocess
import sys
import time

import numpy as np

SEED = 7
BATCH = 1536
LOOKUP_SAMPLE_READS = 256
LOOKUP_RANDOM = 1 << 16
GROUP_TIMEOUT_S = 3000


def rss_gb() -> float:
    """Peak resident set of this process, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def sizes(n_chrom=None, chrom_mb=None, n_reads=None):
    """(chromosomes, Mb per chromosome, reads): those given, the rest from
    the environment."""
    return (n_chrom or int(os.environ.get("DRYRUN_CHROMS", "24")),
            chrom_mb or float(os.environ.get("DRYRUN_CHROM_MB", "129")),
            n_reads or int(os.environ.get("DRYRUN_READS", "50000")))


def _random_codes(rng, total: int) -> np.ndarray:
    """Uniform base codes in 64 MB chunks: one rng.integers(..., np.int64)
    over the whole genome would make an int64 intermediate eight times its
    size (25 GB at GRCh38 scale)."""
    out = np.empty(total, np.uint8)
    CH = 64 << 20
    for off in range(0, total, CH):
        n = min(CH, total - off)
        out[off: off + n] = rng.integers(0, 4, n, dtype=np.int64
                                         ).astype(np.uint8)
    return out


def gen_workload(n_chrom: int, chrom_mb: float, n_reads: int):
    """(genome, chromosome offsets, reads, truths, names); the same on
    every process."""
    from .. import synth
    from ..io.fasta import Genome
    rng = np.random.default_rng(SEED)
    per = int(chrom_mb * 1e6)
    total = n_chrom * per
    codes = _random_codes(rng, total)
    offsets = np.arange(n_chrom + 1, dtype=np.int64) * per
    genome = Genome([f"chr{i + 1}" for i in range(n_chrom)], codes, offsets)
    reads, truths = synth.simulate_reads(genome, n_reads, rng)
    # the simulator plants on the flat buffer: drop reads whose gene
    # crosses a chromosome boundary
    keep = []
    for i, parts in enumerate(truths):
        lo, hi = parts[0][0], parts[-1][1]
        t = np.searchsorted(offsets, lo, side="right") - 1
        if hi <= offsets[t + 1]:
            keep.append(i)
    reads = [reads[i] for i in keep]
    truths = [truths[i] for i in keep]
    names = [f"read{i}" for i in range(len(reads))]
    return genome, offsets, reads, truths, names


def exact_chains(truths, names, primary, offsets) -> int:
    """Reads whose primary record's exon chain equals the planted one.
    `primary` maps a name to (tid, pos, flag, cigar); the truth is in
    flat-buffer coordinates and a record in its chromosome's."""
    from ..io.sam import AlnRec
    from ..transcript.exon_chain import gen_exons
    exact = 0
    for i, parts in enumerate(truths):
        hit = primary.get(names[i])
        if hit is None:
            continue
        tid, pos, flag, cigar = hit
        ts = []
        for (a1, b1), (a2, b2) in zip(parts[:-1], parts[1:]):
            ts += [b1, a2 + 1]
        base = int(offsets[tid])
        es, ee, _ = gen_exons(AlnRec(qname=names[i], flag=flag, tid=tid,
                                     pos=pos, cigar=cigar), 3, 3, 50)
        got = []
        for j in range(len(es) - 1):
            got += [base + int(ee[j]), base + int(es[j + 1])]
        if got == ts:
            exact += 1
    return exact


def primaries(recs) -> dict:
    """name -> (tid, pos, flag, cigar) of the records that are not
    secondary."""
    return {r.qname: (r.tid, r.pos, r.flag, r.cigar) for r in recs
            if not (r.flag & 0x100)}


def check_seed_lookup(aligner, idx, reads) -> int:
    """The device lookup's (lo, hi) against MinimizerIndex.lookup on the
    minimizers of the first reads and on random 2k-bit hashes; returns the
    number of queries, raises GuardError on a difference."""
    from ..diag.measure import GuardError
    h = aligner._batch_minimizers(reads[:LOOKUP_SAMPLE_READS])[0]
    rnd = np.random.default_rng(SEED + 1).integers(
        0, 1 << (2 * int(idx.k)), LOOKUP_RANDOM, dtype=np.int64
    ).astype(h.dtype)
    q = np.concatenate([h, rnd])
    got = aligner._seed_lookup.lookup(q)
    want = idx.lookup(q)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise GuardError("the device seed lookup's (lo, hi) differ from "
                         "MinimizerIndex.lookup")
    return len(q)


def run_single(device="cuda", n_chrom=None, chrom_mb=None,
               n_reads=None) -> dict:
    """The single-process arm at the given sizes (default: sizes());
    raises GuardError on a mismatch."""
    from .. import synth
    from ..align.batch import BatchAligner, TorchBatchAligner
    from ..device import resolve_device
    from ..diag.measure import GuardError, align_pass, first_diff
    from ..index.minimizer import MinimizerIndex
    dev = resolve_device(device)
    n_chrom, chrom_mb, n_reads = sizes(n_chrom, chrom_mb, n_reads)
    t0 = time.perf_counter()
    genome, offsets, reads, truths, names = gen_workload(n_chrom, chrom_mb,
                                                         n_reads)
    workload_s = time.perf_counter() - t0
    total = int(offsets[-1])
    print(f"# genome {total / 1e9:.2f} Gbp, {len(reads)} reads in "
          f"{workload_s:.0f} s, rss={rss_gb():.1f}G", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    idx = MinimizerIndex.build(genome)
    index_s = time.perf_counter() - t0
    idx_gb = (idx.hashes.nbytes + idx.pos.nbytes + idx.strand.nbytes) / 1e9
    print(f"# index built in {index_s:.0f} s, {len(idx.hashes) / 1e6:.0f}M "
          f"minimizers ({idx_gb:.1f} GB), rss={rss_gb():.1f}G",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    al = TorchBatchAligner(genome, index=idx, device=dev, seed_lookup=True)
    table_s = time.perf_counter() - t0
    if al._seed_lookup is None:
        raise GuardError(f"the index of {len(idx.hashes)} minimizers does "
                         "not take the device seed lookup")
    n_checked = check_seed_lookup(al, idx, reads)
    seqset = synth.pack_seqset(reads, names)
    p = align_pass(al, seqset, dev, batch_size=BATCH)
    rss_card = rss_gb()
    print(f"# device path: {len(reads)} reads in {p['wall_s']:.1f} s, "
          f"rss={rss_card:.1f}G", file=sys.stderr, flush=True)
    host = BatchAligner(genome, index=idx)
    t0 = time.perf_counter()
    rb_host = host.align_seqset_packed(seqset, batch_size=BATCH)
    sam_host = rb_host.emit_sam(host.refs)
    host_s = time.perf_counter() - t0
    host.close()
    if p["sam"] != sam_host:
        raise GuardError("the device path's SAM differs from the host "
                         "backend's: " + first_diff(p["sam"], sam_host))
    prim = primaries(p["rb"].to_alnrecs())
    exact = exact_chains(truths, names, prim, offsets)
    n = len(reads)
    al.close()
    return {
        "genome_gbp": round(total / 1e9, 2), "genome_bases": total,
        "n_chrom": n_chrom, "chrom_mb": chrom_mb,
        "minimizers_m": round(len(idx.hashes) / 1e6, 1),
        "index_gb": round(idx_gb, 2),
        "workload_s": workload_s, "index_build_s": index_s,
        "seed_table_upload_s": table_s,
        "seed_table_mb": al._seed_lookup.table.numel() * 4 / 2**20,
        "seed_lookup_queries_checked": n_checked,
        "n_reads": n, "batch": BATCH,
        "align_wall_s": p["wall_s"], "reads_per_s": n / p["wall_s"],
        "host_backend_wall_s": host_s,
        "sam_identical_to_host_backend": True,
        "aligned_frac": round(len(prim) / n, 4),
        "exact_exon_chain_frac": round(exact / n, 4),
        "launches": p["launches"], "kernel_ms": p["kernel_ms"],
        "seed_lookup_calls": p["stats"]["seed_lookup_calls"],
        "host_phases_s": {k[:-2]: p["stats"].get(k, 0.0) for k in
                          ("seed_s", "dispatch_s", "build_s", "polish_s")},
        "peak_device_mb": p["peak_device_mb"],
        "peak_rss_gb_after_device_path": rss_card,
        "peak_rss_gb": rss_gb(),
    }


def _trim_heap() -> None:
    """Return freed heap pages to the OS, so that ru_maxrss is not held up
    by the collective path's per-batch frames."""
    import ctypes
    import gc
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


def _lockstep(al, idx, names, reads, my, n_batches) -> list:
    """Every batch of this process's reads through `al`, in lockstep with
    the group (an empty collective lookup where this process has no batch
    left); the records."""
    recs = []
    for b in range(n_batches):
        part = my[b * BATCH: (b + 1) * BATCH]
        if part:
            h = al.dispatch_batch([names[i] for i in part],
                                  [reads[i] for i in part])
            recs.extend(al.finish_batch(h))
        else:
            idx.lookup_collective(np.zeros(0, np.uint64))
        if b and b % 32 == 0:
            _trim_heap()
    return recs


def shard_worker(pid: int, nproc: int, coord: str, device) -> dict:
    """One process of the sharded arm."""
    import torch

    from ..align.batch import BatchAligner, TorchBatchAligner
    from ..device import resolve_device
    from ..diag.measure import GuardError
    from ..ops import _build
    from ..parallel.distributed import barrier, end_multihost, init_multihost
    from ..parallel.shard_index import ShardedMinimizerIndex
    dev = resolve_device(device)
    init_multihost(coord, nproc, pid)
    n_chrom, chrom_mb, n_reads = sizes()
    genome, offsets, reads, truths, names = gen_workload(n_chrom, chrom_mb,
                                                         n_reads)
    t0 = time.perf_counter()
    idx = ShardedMinimizerIndex.build(genome, nproc, local_shard=pid)
    index_s = time.perf_counter() - t0
    print(f"# [{pid}] shard built in {index_s:.0f} s "
          f"({idx.resident_bytes() / 1e9:.1f} GB), rss={rss_gb():.1f}G",
          file=sys.stderr, flush=True)
    al = TorchBatchAligner(genome, index=idx, device=dev, seed_lookup=False)
    al.warmup_chain_shapes()
    my = list(range(pid, len(reads), nproc))
    n_batches = math.ceil(math.ceil(len(reads) / nproc) / BATCH)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    recs = _lockstep(al, idx, names, reads, my, n_batches)
    align_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    rss_card = rss_gb()
    host = BatchAligner(genome, index=idx)
    t0 = time.perf_counter()
    recs_host = _lockstep(host, idx, names, reads, my, n_batches)
    host_s = time.perf_counter() - t0

    def key(r):
        return (r.qname, r.flag, r.tid, r.pos, r.mapq, r.cigar.tobytes())

    if [key(r) for r in recs] != [key(r) for r in recs_host]:
        raise GuardError(f"process {pid}: the device path's records differ "
                         "from the host backend's")
    prim = primaries(recs)
    out = {
        "process": pid, "n_shards": nproc,
        "shard_index_gb": round(idx.resident_bytes() / 1e9, 2),
        "index_build_s": index_s, "n_reads": len(my),
        "aligned": len(prim),
        "exact": exact_chains(truths, names, prim, offsets),
        "align_wall_s": align_s, "host_backend_wall_s": host_s,
        "records_identical_to_host_backend": True,
        "launches": launches,
        "peak_device_mb": (torch.cuda.max_memory_allocated(dev) / 2**20
                           if dev.type == "cuda" else None),
        "peak_rss_gb_after_device_path": rss_card,
        "peak_rss_gb": rss_gb(),
        "collective": dict(idx.coll_stats),
    }
    barrier("dryrun-done")
    end_multihost()
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_sharded(n_shards: int, device="cuda") -> dict:
    """Start the sharded arm's processes, wait for all, merge their
    lines; raises GuardError when one fails."""
    from ..diag.measure import GuardError
    coord = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ,
           "PYTHONPATH": repo + (os.pathsep + path if path else "")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--shard-worker", str(pid),
         "--shards", str(n_shards), "--coord", coord, "--device",
         str(device)], stdout=subprocess.PIPE, text=True, env=env)
        for pid in range(n_shards)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.perf_counter() - t0 > GROUP_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    if any(p.returncode != 0 for p in procs):
        raise GuardError("sharded arm: process exit codes "
                         f"{[p.returncode for p in procs]}")
    stats = [json.loads([ln for ln in so.splitlines()
                         if ln.startswith("{")][-1]) for so in outs]
    n_reads = sum(s["n_reads"] for s in stats)
    return {
        "n_shards": n_shards, "per_process": stats,
        "peak_rss_gb_max": max(s["peak_rss_gb"] for s in stats),
        "aligned_frac": round(sum(s["aligned"] for s in stats) / n_reads, 4),
        "exact_exon_chain_frac": round(
            sum(s["exact"] for s in stats) / n_reads, 4),
        "n_reads_total": n_reads,
        "reads_per_s_aggregate": n_reads / max(s["align_wall_s"]
                                               for s in stats),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--shards", type=int, default=0,
                    help="run the sharded arm over this many processes")
    ap.add_argument("--out", help="also write the result line here")
    ap.add_argument("--shard-worker", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coord", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..diag.measure import GuardError, device_detail
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"dryrun_grch38: {e}", file=sys.stderr)
        return 2
    try:
        if args.shard_worker is not None:
            print(json.dumps(shard_worker(args.shard_worker, args.shards,
                                          args.coord, dev)), flush=True)
            return 0
        res = (run_sharded(args.shards, args.device) if args.shards
               else run_single(dev))
    except GuardError as e:
        print(f"dryrun_grch38: guard failed: {e}", file=sys.stderr)
        return 1
    line = {"metric": "grch38_dryrun", **device_detail(dev), **res}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
            f.write("\n")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
