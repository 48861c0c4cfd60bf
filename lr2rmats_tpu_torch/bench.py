"""Throughput benchmark of the port: long reads aligned per second on one
card.

The counterpart of the repository's bench.py.  Run from the repository
root:

    python -m lr2rmats_tpu_torch.bench                # on the card
    python -m lr2rmats_tpu_torch.bench --device cpu   # plain versions

Workload (bench.py's, generated by synth.py, the same bytes): one random
chromosome of BENCH_GENOME_MB (20) Mb, BENCH_READS (6144) reads over
planted genes with the BENCH_ERR_PROFILE (ont; "clean", "none" or "" for
the clean profile) error profile, seed 123.  The reads go through
`TorchBatchAligner(genome, device=...)` with its defaults; the port's
switches (LR2RMATS_DEVICE_JUNCTIONS=1, LR2RMATS_DEVICE_SEED=1,
LR2RMATS_BATCH) are read from the environment as everywhere else, and the
bench sets none of them.  After the warm-up (`warmup_chain_shapes`, then 64
reads) BENCH_REPEATS (3) timed passes of `align_seqset_packed` + `emit_sam`
run; the value is the best pass's reads/s.  The ONT arm is followed, unless
BENCH_SKIP_CLEAN is set, by the clean arm: max(N/4, 512) clean-profile
reads on a second genome from the same seed, best of 2.  BENCH_PROFILE=<dir>
writes a torch.profiler trace of the ONT arm's timed passes there
(trace.json and a kernel table).

The guard: every timed pass's SAM must equal the first's, and after the
timed passes the same reads go once through the port's host backend
(`BatchAligner`, the host yardstick); the SAM must equal it byte for byte
and the accuracy (aligned, exact exon chains, splice-site recall) must
equal it.  A mismatch exits 1 with no result line: it is not reported as a
slower number.

Prints one JSON line,
  {"metric": "long_reads_aligned_per_sec_per_chip", "value": reads/s,
   "unit": "reads/s", "detail": {...}},
whose detail names the card (`card`: nvidia-smi's name and power limit)
and holds every pass's wall and their median beside the best, each
kernel's launches and summed CUDA-event milliseconds in the best pass, the
card's idle share of that pass (1 - kernel time / wall), the peak card
memory, the host phases, and the set-up (workload, index build, kernel
build, warm-up) apart from the wall.  With --device cpu the metric is
"long_reads_aligned_per_sec_on_cpu" and the card's fields are null.
Without a card and without --device cpu it exits 2 and prints no result
line: there is no fallback to the CPU.

Not ported from bench.py, and why:
  * the supervisor (`_supervised`, `_run_attempt`, `_fallback_json`): it
    guarded a hung remote link and fell back to the CPU with value 0, a
    fallback that hides the device;
  * `_enable_compile_cache`: the JAX compilation cache;
  * `_probe_link` and the weather preflip: there is no remote link;
  * `vs_baseline` against BENCH_BASELINE.json: that value is a TPU's;
  * the v5e roofline `est_device_gflops` / `vpu_util_est`: replaced by the
    kernels' CUDA-event time and the card's idle share;
  * BENCH_SELFTEST_HANG, the supervisor's self-test hook.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from typing import Optional

import numpy as np

from . import synth
from .utils import log

SEED = 123
WARMUP_READS = 64
CLEAN_REPEATS = 2
PHASES = ("seed_s", "dispatch_s", "build_s", "polish_s")


def workload(genome_mb: float, n_reads: int, profile: Optional[str],
             seed: int = SEED):
    """(genome, reads, truths, names) of bench.py's generator."""
    rng = np.random.default_rng(seed)
    genome = synth.build_genome(int(genome_mb * 1e6), rng)
    reads, truths = synth.simulate_reads(genome, n_reads, rng,
                                         profile=profile)
    names = [f"read{i}" for i in range(len(reads))]
    return genome, reads, truths, names


def accuracy(rb, truths, names) -> dict:
    """Counts of a RecordBatch against the planted truth: `aligned`
    (records that are not secondary), `primaries` (reads with one),
    `exact` (exact exon chains), `site_tp` and `site_n` (splice sites)."""
    primary = {}
    aligned = 0
    for r in rb.to_alnrecs():
        if not (r.flag & 0x100):
            aligned += 1
            primary[r.qname] = r
    exact, site_tp, site_n = synth.accuracy_vs_truth(truths, names, primary)
    return {"aligned": aligned, "primaries": len(primary), "exact": exact,
            "site_tp": site_tp, "site_n": site_n}


def host_guard(aligner, seqset, sam: bytes, acc: dict, truths,
               tag: str) -> float:
    """The same reads through the port's host backend on the aligner's
    index; raises GuardError unless the SAM bytes and the accuracy are
    equal.  Returns the host backend's wall seconds."""
    from .align.batch import BatchAligner
    from .diag.measure import GuardError, first_diff
    host = BatchAligner(aligner.inner.genome, aligner.p, index=aligner.index)
    t0 = time.perf_counter()
    rb = host.align_seqset_packed(seqset)
    sam_host = rb.emit_sam(host.refs)
    wall = time.perf_counter() - t0
    host.close()
    if sam != sam_host:
        raise GuardError(f"{tag}: SAM differs from the host backend: "
                         + first_diff(sam, sam_host))
    acc_host = accuracy(rb, truths, list(seqset.names))
    if acc != acc_host:
        raise GuardError(f"{tag}: accuracy {acc} differs from the host "
                         f"backend's {acc_host}")
    return wall


def measure(aligner, seqset, truths, repeats: int, tag: str, dev):
    """Best of `repeats` timed passes (bench.py `_measure`), each through
    diag/measure.py `align_pass`.  Every pass's SAM must equal the first's.
    Returns (reads/s of the best pass, its SAM, its accuracy counts, the
    arm's detail)."""
    from .diag.measure import GuardError, align_pass, first_diff
    walls = []
    best = None
    sam0 = None
    for k in range(max(repeats, 1)):
        log("bench", "%s: repeat %d/%d (%d reads)", tag, k + 1, repeats,
            seqset.n)
        p = align_pass(aligner, seqset, dev)
        if sam0 is None:
            sam0 = p["sam"]
        elif p["sam"] != sam0:
            raise GuardError(f"{tag}: repeat {k + 1}'s SAM differs from "
                             "repeat 1's: " + first_diff(p["sam"], sam0))
        walls.append(p["wall_s"])
        if best is None or p["wall_s"] < best["wall_s"]:
            best = p
        log("bench", "%s: repeat %d done in %.3f s", tag, k + 1,
            p["wall_s"])
    names = list(seqset.names)
    acc = accuracy(best["rb"], truths, names)
    n = seqset.n
    wall = best["wall_s"]
    st = best["stats"]
    kernel_s = sum(best["kernel_ms"].values()) / 1e3
    detail = {
        "align_wall_s": wall,
        "repeat_walls_s": walls,
        "median_wall_s": statistics.median(walls),
        "median_reads_per_sec": n / statistics.median(walls),
        "aligned_frac": round(acc["aligned"] / n, 4),
        "exact_exon_chain_frac": round(acc["exact"] / n, 4),
        "splice_site_recall": round(acc["site_tp"] / max(acc["site_n"], 1),
                                    4),
        "emit_s": best["emit_s"],
        "launches": best["launches"],
        "kernel_ms": best["kernel_ms"],
        "kernel_s": kernel_s,
        "idle_share": 1.0 - kernel_s / wall if dev.type == "cuda" else None,
        "peak_device_mb": best["peak_device_mb"],
        "host_phases_s": {k[:-2]: st.get(k, 0.0) for k in PHASES},
        "chain_fetch_wall_s": st["device_wall_s"],
        "anchors_chained": st["anchors"],
        "seed_lookup_calls": st.get("seed_lookup_calls", 0),
        "junction_gaps": st.get("junction_gaps", 0),
    }
    return n / wall, best["sam"], acc, detail


def run_arm(genome_mb: float, n_reads: int, profile: Optional[str],
            repeats: int, dev, profile_dir: Optional[str] = None) -> dict:
    """One arm of the bench: workload, aligner (index build), kernel
    build, warm-up, the timed passes and the host guard.  Returns the
    arm's detail with "reads_per_sec"; raises GuardError on a mismatch."""
    from .align.batch import TorchBatchAligner
    from .ops import _build
    tag = profile or "clean"
    t0 = time.perf_counter()
    genome, reads, truths, names = workload(genome_mb, n_reads, profile)
    workload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aligner = TorchBatchAligner(genome, device=dev)
    index_s = time.perf_counter() - t0
    kernel_build_s = 0.0
    if dev.type == "cuda":
        _build.load()
        kernel_build_s = float(_build.build_info.get("build_s", 0.0))
    t0 = time.perf_counter()
    aligner.warmup_chain_shapes()
    aligner.align_batch(names[:WARMUP_READS], reads[:WARMUP_READS])
    warmup_s = time.perf_counter() - t0
    seqset = synth.pack_seqset(reads, names)
    with _profiled(dev, profile_dir):
        rps, sam, acc, detail = measure(aligner, seqset, truths, repeats,
                                        tag, dev)
    host_wall = host_guard(aligner, seqset, sam, acc, truths, tag)
    aligner.close()
    return {
        "err_profile": tag, "n_reads": len(reads), "genome_mb": genome_mb,
        "reads_per_sec": rps, **detail,
        "sam_bytes": len(sam), "sam_identical_to_host_backend": True,
        "host_backend_wall_s": host_wall,
        "junction_backend": aligner.junction_backend,
        "device_seed_lookup": aligner._seed_lookup is not None,
        "setup_s": {"workload": workload_s, "index_build": index_s,
                    "kernel_build": kernel_build_s, "warmup": warmup_s},
        "setup_wall_s": workload_s + index_s + kernel_build_s + warmup_s,
    }


@contextlib.contextmanager
def _profiled(dev, out_dir: Optional[str]):
    """A torch.profiler trace of the block into out_dir (trace.json, and
    kernels.txt: the table of key_averages); nothing when out_dir is
    None."""
    if not out_dir:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    key = ("self_device_time_total" if dev.type == "cuda"
           else "self_cpu_time_total")
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=40))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu (the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    from .device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    from .align.batch import DEFAULT_BATCH
    from .diag.measure import GuardError, device_detail
    genome_mb = float(os.environ.get("BENCH_GENOME_MB", "20"))
    n_reads = int(os.environ.get("BENCH_READS", "6144"))
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    profile = os.environ.get("BENCH_ERR_PROFILE", "ont")
    if profile in ("clean", "none", ""):
        profile = None
    try:
        arm = run_arm(genome_mb, n_reads, profile, repeats, dev,
                      os.environ.get("BENCH_PROFILE") or None)
        clean = None
        if profile == "ont" and not os.environ.get("BENCH_SKIP_CLEAN"):
            clean = run_arm(genome_mb, max(n_reads // 4, 512), None,
                            CLEAN_REPEATS, dev)
    except GuardError as e:
        print(f"bench: guard failed: {e}", file=sys.stderr)
        return 1
    import torch
    detail = {**device_detail(dev), "torch": torch.__version__,
              "cuda": torch.version.cuda, "batch": DEFAULT_BATCH, **arm}
    if clean is not None:
        detail["clean_reads_per_sec"] = clean["reads_per_sec"]
        detail["clean_exact_exon_chain_frac"] = clean[
            "exact_exon_chain_frac"]
        detail["clean"] = clean
    metric = ("long_reads_aligned_per_sec_per_chip" if dev.type == "cuda"
              else "long_reads_aligned_per_sec_on_cpu")
    print(json.dumps({"metric": metric, "value": arm["reads_per_sec"],
                      "unit": "reads/s", "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
