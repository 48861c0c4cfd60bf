#!/usr/bin/env python3
"""Smoke test of lr2rmats_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:

    python3 chip_smoke.py                 # bench workload, 6144 ONT reads
    python3 chip_smoke.py --reads 100000  # larger slices

Phases (each prints its own lines and wall time; any failure raises and
exits non-zero):
  1. device: requires torch.cuda.is_available(); prints nvidia-smi's name
     and power limit of the card;
  2. build: compiles the CUDA kernels from lr2rmats_tpu_torch/csrc with
     nvcc for sm_90a and prints the build time and ptxas report;
  3. kernels: each kernel against its plain PyTorch version on the card at
     main-path shapes, exact, with CUDA-event times of both: chain at
     A=128/B=1664 and A=64/B=320 on anchor rows of the workload's first
     batch plus random rows; shift DP at band 8, M=192, G=256/512 and band
     4, M=64, G=128, and both junction flanks at the G of the first batch;
     combine on the junction gaps of the first batch plus random gaps (G >=
     2048), all six outputs; hamming at 131072 candidates of 150 bases,
     windows past the buffer end included; and the two torch-op ports (seed
     lookup, junction counts) against their host versions, host-clock
     times;
  4. slice 1: TorchBatchAligner(device="cuda").align_seqset_packed on the
     bench.py workload (20 Mb genome, ONT profile, seed 123, batch 1536)
     then emit_sam; the same seqset through the reference package's host
     backend (BatchAligner(backend="host"), which imports no jax); the SAM
     bytes and accuracy must be identical;
  5. slice 2: the same with the device junction DP and the device seed
     lookup (junction_backend="device", seed_lookup=True); SAM identical
     to the host backend;
  6. pipeline: scripts/simulate.py at its defaults (12 Mb genome, 200
     genes, 20000 long reads, 50000 short pairs, seed 7), then
     `python -m lr2rmats_tpu_torch run` (its main, in this process) with
     LR2RMATS_DEVICE_JUNCTIONS=1, LR2RMATS_DEVICE_SEED=1 and
     LR2RMATS_DEVICE_SJCOUNT=1, and the reference's
     run_pipeline(use_tpu=False); every file under output/, the SAM, the
     BED and the STARSJ table must be byte-identical;
  7. multi-process: (a) a world-1 process group (gloo for the CPU, NCCL for
     the card) and make_mesh(1, 1, "cuda"); sharded_align_step on the bench
     index and the first batch's reads (Q=128 minimizers, 4 hits per seed,
     so 512 anchors per read, the chain kernel's limit) equals the same
     step over the plain chain DP exactly; (b) phase 6's long reads split
     into two samples (halves, each with all short pairs) through two
     `python -m lr2rmats_tpu_torch run` processes of one group on the card
     with the three device switches; updated.gtf and every per-sample
     output equal the reference's host pipeline on the same lists; (c) two
     processes, each holding one hash range of the bench index
     (ShardedMinimizerIndex.build(local_shard=pid)), align 768 bench reads
     each in lockstep through the collective lookup with
     TorchBatchAligner(device="cuda"); the primaries equal the
     single-process full-index host run.  Both processes of (b) and (c)
     share the one card; their payloads travel over gloo.
Launch counts are set to 0 before each of phases 4-7 and read after (the
processes of 7b and 7c start at 0 and report theirs); every kernel must
have been launched by one of them.  Then one JSON line with the kernels,
and the last line {"ok": true, "device": {...}}.  Work files go under
build/chip_smoke/.

Neither this script nor the port imports jax: it is blocked below.
"""

import sys

sys.modules["jax"] = None  # any jax import in the slice fails loudly

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np

SEED = 123
GENOME_MB = 20.0
CHAIN_SHAPES = ((128, 1664), (64, 320))          # (A, chunk rows)
SHIFT_SHAPES = ((8, 192, 256, "int8"), (8, 192, 512, "int8"),
                (4, 64, 128, "int32"))           # (band, M, G, dtype)
COMBINE_MIN_G = 2048
HAMMING_C, HAMMING_L = 131072, 150
SWITCHES = ("LR2RMATS_DEVICE_JUNCTIONS", "LR2RMATS_DEVICE_SEED",
            "LR2RMATS_DEVICE_SJCOUNT")
PATH_KERNELS = ("chain_dp_backtrack", "shift_dp", "combine", "hamming")
MESH_READS, MESH_Q, MESH_H = 1536, 128, 4
LOOKUP_READS, LOOKUP_BATCH = 768, 256
GROUP_TIMEOUT_S = 300


def say(tag, msg):
    print(f"[{tag}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def random_anchor_rows(rng, B, A):
    """Anchor rows shaped like tests/test_chain_jax.py:random_anchor_rows:
    2-3 exon chains plus 20% noise anchors, sorted by (rpos, qpos)."""
    qp = np.zeros((B, A), np.int32)
    rp = np.zeros((B, A), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(5, A + 1))
        q = np.sort(rng.integers(0, 2000, n))
        r = q + 10_000
        for ia in rng.integers(0, 2000, 2):
            r = np.where(q > ia, r + int(rng.integers(50, 5000)), r)
        noise = rng.random(n) < 0.2
        r = np.where(noise, rng.integers(0, 60_000, n), r)
        order = np.lexsort((q, r))
        qp[b, :n], rp[b, :n], ns[b] = q[order], r[order], n
    return qp, rp, ns


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check_chain(aligner, first_batch, dev):
    """Chain kernel == plain version at the main-path chunk shapes."""
    import torch
    from lr2rmats_tpu_torch.ops.chain import (chain_dp_backtrack,
                                              chain_dp_backtrack_reference,
                                              chain_dp_reference,
                                              chain_params_for_kernel)
    kp = chain_params_for_kernel(aligner.p.chain)
    min_score = aligner.p.min_score
    prep = aligner._prepare_dispatch(aligner._batch_anchors(first_batch))
    rng = np.random.default_rng(SEED)
    worst, times = 0.0, {}
    for A, C in CHAIN_SHAPES:
        real = next((c for c in prep["chunks"] if c[1] == A), None)
        qp, gp, nn = random_anchor_rows(rng, C, A)
        n_real = 0
        if real is not None:
            n_real = len(real[0])
            qp[:n_real], gp[:n_real], nn[:n_real] = (real[2][:n_real],
                                                     real[3][:n_real],
                                                     real[4][:n_real])
        q, g, n = (torch.from_numpy(a).to(dev) for a in (qp, gp, nn))
        mask, ps, ss, f, parent = chain_dp_backtrack(q, g, n, kp, min_score,
                                                     dp_out=True)
        rf, rparent = chain_dp_reference(q, g, n, kp)
        rmask, rps, rss = chain_dp_backtrack_reference(q, g, n, kp,
                                                       min_score)
        torch.cuda.synchronize()
        valid = torch.arange(A, device=dev)[None, :] < n[:, None]
        err = max(float((f - rf)[valid].abs().max()),
                  float((ps - rps).abs().max()),
                  float((ss - rss).abs().max()))
        worst = max(worst, err)
        same = (torch.equal(parent, rparent) and torch.equal(f, rf)
                and torch.equal(mask, rmask) and torch.equal(ps, rps)
                and torch.equal(ss, rss))
        ms = cuda_ms(lambda: chain_dp_backtrack(q, g, n, kp, min_score), 20)
        plain_ms = cuda_ms(
            lambda: chain_dp_backtrack_reference(q, g, n, kp, min_score), 2)
        times[(A, C)] = (ms, plain_ms)
        say("kernels", f"chain_dp_backtrack A={A} B={C}: {n_real} workload "
            f"rows + {C - n_real} random rows, {int(n.sum())} anchors, "
            f"primaries {int((ps > 0).sum())}, secondaries "
            f"{int((ss > 0).sum())}; exact={same} max_abs_err={err} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
        if not same:
            bad = (parent != rparent).any(1) | (mask != rmask).any(1) | \
                (ps != rps) | (ss != rss) | (f != rf).any(1)
            b = int(torch.nonzero(bad)[0])
            raise AssertionError(
                f"chain kernel disagrees with the plain version at A={A}, "
                f"row {b}: f {f[b].tolist()} vs {rf[b].tolist()}, parent "
                f"{parent[b].tolist()} vs {rparent[b].tolist()}")
    return worst, times


def check_shift_dp(genome_codes, dev):
    """Shift-DP kernel == plain version at the main-path shapes."""
    import torch
    from lr2rmats_tpu_torch.ops.splice import shift_dp, shift_dp_reference
    rng = np.random.default_rng(SEED + 1)
    worst, times = 0.0, {}
    for band, M, G, dt in SHIFT_SHAPES:
        npdt = np.int8 if dt == "int8" else np.int32
        pad = -9 if dt == "int8" else 7
        q = np.full((M, G), pad, npdt)
        win = np.full((M + band, G), pad, npdt)
        m = np.zeros(G, np.int32)
        for g in range(G):
            mg = int(rng.integers(0, M + 1))
            L0 = int(rng.integers(0, len(genome_codes) - M - band))
            qw = genome_codes[L0: L0 + mg].astype(npdt)
            mut = rng.random(mg) < 0.08
            qw[mut] = (qw[mut] + 1) % 4
            q[:mg, g] = qw
            win[:mg + band, g] = genome_codes[L0: L0 + mg + band]
            m[g] = mg
        tq, tw, tm = (torch.from_numpy(a).to(dev) for a in (q, win, m))
        got = shift_dp(tq, tw, tm, band)
        want = shift_dp_reference(tq, tw, tm, band)
        torch.cuda.synchronize()
        fin = want > -1e17
        err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
        same = torch.equal(got, want)
        worst = max(worst, err)
        ms = cuda_ms(lambda: shift_dp(tq, tw, tm, band), 20)
        plain_ms = cuda_ms(lambda: shift_dp_reference(tq, tw, tm, band), 2)
        times[(band, M, G)] = (ms, plain_ms)
        say("kernels", f"shift_dp band={band} M={M} G={G} {dt}: exact={same} "
            f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
        if not same:
            raise AssertionError(f"shift_dp kernel disagrees with the plain "
                                 f"version at band={band} M={M} G={G}")
    return worst, times


def random_gaps(rng, codes, n):
    """Junction gaps (q, left_ref, right_ref, el, er) on the genome: the
    tests/test_splice_device.py recipe (m < 64, 15% query mutations), a
    quarter with spans too short for an intron, anchor-prior centres 0-6."""
    gaps = []
    for _ in range(n):
        m = int(rng.integers(0, 64))
        lr = int(rng.integers(100, len(codes) - 20_000))
        short = rng.random() < 0.25
        span = int(rng.integers(m + 4, m + 20) if short else
                   rng.integers(m + 40, m + 5000))
        q = codes[lr: lr + m].copy()
        mut = rng.random(m) < 0.15
        q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        gaps.append((q, lr, lr + span, int(rng.integers(0, 7)),
                     int(rng.integers(0, 7))))
    return gaps


def check_junction(aligner, first_batch, dev):
    """Both junction flank shift DPs and the combine kernel == their plain
    versions on the junction gaps of the workload's first batch (the native
    collect pass of the device junction backend) plus random gaps."""
    import torch
    from lr2rmats_tpu.native import get_lib
    from lr2rmats_tpu_torch.ops.junction import (B_DEF, combine,
                                                 combine_reference,
                                                 prepare_junction_batch)
    from lr2rmats_tpu_torch.ops.splice import shift_dp, shift_dp_reference
    codes = aligner.inner.genome.codes
    rows = aligner._batch_anchors(first_batch)
    chained = aligner._chain_rows(rows)
    per_read = aligner._collect_candidates(rows, chained)
    packed = aligner._flatten_candidates(first_batch, per_read,
                                         sorted(per_read))
    _, gaps, _ = aligner._collect_junction_gaps(get_lib(), packed,
                                                len(packed[1]))
    n_real = len(gaps)
    rng = np.random.default_rng(SEED + 2)
    gaps += random_gaps(rng, codes, max(COMBINE_MIN_G - n_real, 256))
    b = prepare_junction_batch(codes, gaps, B_DEF)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in b.items() if k != "B"}
    G = len(gaps)
    flanks = (("q", "lwin"), ("qr", "rwin"))
    S = [shift_dp(t[q], t[w], t["m"], B_DEF) for q, w in flanks]
    S_ref = [shift_dp_reference(t[q], t[w], t["m"], B_DEF)
             for q, w in flanks]
    args = (*S, t["m"], t["span"], t["dok"], t["aok"], t["el"], t["er"],
            B_DEF, aligner.p.min_intron_len)
    got = combine(*args)
    want = combine_reference(*args)
    torch.cuda.synchronize()
    shift_same = all(torch.equal(a, r) for a, r in zip(S, S_ref))
    same = [torch.equal(a, r) for a, r in zip(got, want)]
    fin = want[5]
    err = float((got[0] - want[0])[fin].abs().max()) if bool(fin.any()) \
        else 0.0
    shift_ms = cuda_ms(lambda: [shift_dp(t[q], t[w], t["m"], B_DEF)
                                for q, w in flanks], 20) / 2
    shift_plain = cuda_ms(lambda: [shift_dp_reference(t[q], t[w], t["m"],
                                                      B_DEF)
                                   for q, w in flanks], 1) / 2
    ms = cuda_ms(lambda: combine(*args), 20)
    plain_ms = cuda_ms(lambda: combine_reference(*args), 2)
    say("kernels", f"shift_dp band=4 M=64 G={G} int32 (both junction "
        f"flanks): exact={shift_same} kernel {shift_ms:.4f} ms, plain "
        f"{shift_plain:.2f} ms per flank")
    say("kernels", f"combine G={G}: {n_real} gaps of the first batch + "
        f"{G - n_real} random, found {int(fin.sum())}; exact(score, j, cl, "
        f"cr, vote, found)={same} max_abs_err={err} kernel {ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms")
    if not shift_same:
        raise AssertionError("junction shift_dp disagrees with the plain "
                             "version")
    if not all(same):
        bad = torch.zeros(G, dtype=torch.bool, device=dev)
        for a, r in zip(got, want):
            bad |= a != r
        g = int(torch.nonzero(bad)[0])
        raise AssertionError(
            f"combine kernel disagrees with the plain version at gap {g}: "
            f"{[x[g].item() for x in got]} vs {[x[g].item() for x in want]}")
    return err, (ms, plain_ms)


def check_hamming(codes, dev):
    """hamming kernel == plain version: HAMMING_C candidates of
    HAMMING_L-base reads against the genome, 1% past the buffer end."""
    import torch
    from lr2rmats_tpu_torch.junctions.sjcount_device import (
        hamming, hamming_reference)
    rng = np.random.default_rng(SEED + 3)
    n = len(codes)
    S = 4096
    starts = rng.integers(0, n - HAMMING_L, S)
    comb = codes[starts[:, None] + np.arange(HAMMING_L)].copy()
    mut = rng.random(comb.shape) < 0.01
    comb[mut] = (comb[mut] + 1) % 4
    off = np.arange(S + 1, dtype=np.int64) * HAMMING_L
    rid = rng.integers(0, S, HAMMING_C).astype(np.int32)
    pos = starts[rid] + rng.integers(-2, 3, HAMMING_C)
    far = rng.random(HAMMING_C) < 0.5
    pos[far] = rng.integers(0, n, int(far.sum()))
    past = rng.random(HAMMING_C) < 0.01
    pos[past] = n - rng.integers(1, HAMMING_L, int(past.sum()))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (codes, comb.reshape(-1), off, rid, pos.astype(np.int64))]
    got = hamming(*args)
    want = hamming_reference(*args)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: hamming(*args), 20)
    plain_ms = cuda_ms(lambda: hamming_reference(*args), 2)
    say("kernels", f"hamming C={HAMMING_C} L={HAMMING_L} over a {n}-base "
        f"buffer ({int(past.sum())} windows past its end): exact={same} "
        f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
    if not same:
        raise AssertionError("hamming kernel disagrees with the plain "
                             "version")
    return err, (ms, plain_ms)


def wall_ms(fn, reps):
    """Mean host-clock milliseconds of fn() over reps calls, each ending in
    a synchronise (for functions whose copies are part of the call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def check_torch_ops(aligner, first_batch, dev):
    """The two device functions ported as torch ops, against the
    reference's host versions: the seed lookup on the first batch's
    minimizer hashes, and the junction counts over 2^20 updates."""
    from lr2rmats_tpu_torch.index.seed_device import TorchSeedLookup
    from lr2rmats_tpu_torch.junctions.sjcount_device import TorchCounts
    idx = aligner.index
    h = aligner._batch_minimizers(first_batch)[0]
    look = TorchSeedLookup(idx, dev)
    seed_same = all(np.array_equal(a, b) for a, b in
                    zip(look.lookup(h), idx.lookup(h)))
    seed_t = (wall_ms(lambda: look.lookup(h), 10),
              wall_ms(lambda: idx.lookup(h), 10))
    rng = np.random.default_rng(SEED + 4)
    n, M = 50_000, 1 << 20
    cc = rng.integers(0, n + 1, M)                   # n is the sentinel
    u = rng.random(M) < 0.7
    over = rng.integers(0, 100, M).astype(np.int32)
    counts = TorchCounts(n, dev)
    counts.add(cc, u, over)
    keep = cc < n

    def host_counts():
        uniq, multi, mx = (np.zeros(n, np.int32) for _ in range(3))
        np.add.at(uniq, cc[keep & u], 1)
        np.add.at(multi, cc[keep & ~u], 1)
        np.maximum.at(mx, cc[keep], over[keep])
        return uniq, multi, mx

    counts_same = all(np.array_equal(a, b) for a, b in
                      zip(counts.fetch(), host_counts()))
    counts_t = (wall_ms(lambda: (counts.add(cc, u, over), counts.fetch()),
                        5),
                wall_ms(host_counts, 2))
    say("kernels", f"torch ops: seed lookup of {len(h)} hashes exact="
        f"{seed_same} card {seed_t[0]:.2f} ms, host {seed_t[1]:.2f} ms; "
        f"junction counts of {M} updates exact={counts_same} card "
        f"{counts_t[0]:.2f} ms, host numpy {counts_t[1]:.2f} ms (host "
        "clock, copies included)")
    if not (seed_same and counts_same):
        raise AssertionError("a torch-op port disagrees with the host "
                             "version")


def align_slice(tag, aligner, seqset, sam_ref, dev):
    """align_seqset_packed + emit_sam with launch counts and kernel times;
    the SAM must equal the host backend's."""
    import torch
    from lr2rmats_tpu_torch.ops import _build
    aligner.stats = aligner.fresh_stats()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    with _build.timing() as kernel_ms:
        t0 = time.perf_counter()
        rb = aligner.align_seqset_packed(seqset)
        sam = rb.emit_sam(aligner.refs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if sam_ref is not None and sam != sam_ref:
        raise AssertionError(f"{tag}: SAM bytes differ from the host "
                             "backend: " + first_diff(sam, sam_ref))
    return rb, sam, wall, launches, kernel_ms, dict(aligner.stats), \
        torch.cuda.max_memory_allocated(dev) / 2**20


def pipeline_outputs(out):
    files = sorted(os.listdir(os.path.join(out, "output")))
    names = [os.path.join("output", f) for f in files] + [
        os.path.join("alignment", f"samp1.{n}") for n in
        ("minimap.sam", "minimap.bed", "STARSJ.out.tab")]
    out_bytes = {}
    for name in names:
        with open(os.path.join(out, name), "rb") as f:
            out_bytes[name] = f.read()
    return out_bytes


def stage_walls(out):
    """Wall seconds per stage from the pipeline's benchmark/ files."""
    walls = {}
    bdir = os.path.join(out, "benchmark")
    for f in sorted(os.listdir(bdir)):
        with open(os.path.join(bdir, f)) as fh:
            walls[f.replace(".benchmark.txt", "")] = float(
                fh.read().splitlines()[1].split()[0])
    return walls


def run_pipeline_phase(here, dev, card):
    """scripts/simulate.py at its defaults; the port's CLI with the three
    device switches; the reference's host pipeline; byte comparison."""
    import torch
    from lr2rmats_tpu.index.minimizer import MinimizerIndex
    from lr2rmats_tpu.io.fasta import Genome
    from lr2rmats_tpu.pipeline.config import PipelineConfig, SampleReads
    from lr2rmats_tpu_torch._reference import parallel_module
    from lr2rmats_tpu_torch.ops import _build
    from lr2rmats_tpu_torch.pipeline.cli import main as port_main
    work = os.path.join(here, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(here, "scripts",
                                                 "simulate.py"),
                    "--out", data], check=True, capture_output=True)
    sim_s = time.perf_counter() - t0
    files = {k: os.path.join(data, v) for k, v in (
        ("genome", "genome.fa"), ("gtf", "anno.gtf"), ("long", "long.fa"),
        ("s1", "short_1.fa"), ("s2", "short_2.fa"))}
    # the index both runs load (build_or_load's cache next to the FASTA)
    t0 = time.perf_counter()
    MinimizerIndex.build_or_load(Genome.load(files["genome"]),
                                 files["genome"] + ".tmmi.npz")
    index_s = time.perf_counter() - t0
    say("pipeline", f"scripts/simulate.py defaults in {sim_s:.1f} s; index "
        f"built in {index_s:.1f} s")

    port_out = os.path.join(work, "port")
    argv = ["run", "--genome", files["genome"], "--gtf", files["gtf"],
            "--long-read", files["long"], "--short-read-1", files["s1"],
            "--short-read-2", files["s2"], "--out-dir", port_out]
    os.environ.update({v: "1" for v in SWITCHES})
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    try:
        t0 = time.perf_counter()
        rc = port_main(argv)
        torch.cuda.synchronize(dev)
        port_s = time.perf_counter() - t0
    finally:
        for v in SWITCHES:
            os.environ.pop(v, None)
    launches = dict(_build.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    if rc != 0:
        raise AssertionError(f"python -m lr2rmats_tpu_torch run exited {rc}")

    ref_out = os.path.join(work, "ref")
    parallel_module("distributed")   # the reference pipeline imports it
    from lr2rmats_tpu.pipeline.stages import run_pipeline as ref_pipeline
    cfg = PipelineConfig(genome_fasta=files["genome"], gtf=files["gtf"])
    cfg.samples["samp1"] = SampleReads(files["long"], files["s1"],
                                       files["s2"])
    cfg.out_dir = ref_out
    t0 = time.perf_counter()
    ref_pipeline(cfg, use_tpu=False)
    ref_s = time.perf_counter() - t0

    got, want = pipeline_outputs(port_out), pipeline_outputs(ref_out)
    diff = [k for k in sorted(set(got) | set(want))
            if got.get(k) != want.get(k)]
    if diff or len(want) != 11:
        raise AssertionError(f"pipeline outputs differ from the reference: "
                             f"{diff} ({len(want)} files)")
    line = {"port_wall_s": port_s, "reference_host_wall_s": ref_s,
            "port_stage_walls_s": stage_walls(port_out),
            "reference_stage_walls_s": stage_walls(ref_out),
            "launches": launches, "peak_device_mb": peak_mb,
            "files_identical": sorted(got), "bytes": {
                k: len(v) for k, v in got.items()},
            "card": card}
    say("pipeline", json.dumps(line))
    say("pipeline", f"port {port_s:.2f} s (reference host {ref_s:.2f} s), "
        f"{len(got)} files byte-identical, launches {launches}")
    return launches


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(cmds, env, cwd, timeout=GROUP_TIMEOUT_S):
    """Start every command at once and wait for all under one deadline;
    as soon as one fails or the deadline passes, kill the rest and raise.
    Returns (walls, stdouts)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, env=env, cwd=cwd, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c in cmds]
    walls = [None] * len(procs)
    try:
        while any(w is None for w in walls):
            for i, p in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.perf_counter() - t0
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate(timeout=60) for p in procs]
    for i, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"process {i} of {len(procs)} exited "
                                 f"{p.returncode}:\n{se[-4000:]}")
    return walls, [so for so, _ in outs]


def mesh_reads(aligner, reads):
    """The first MESH_Q minimizer hashes (uint32) and positions of each
    read; reads with fewer are padded with a hash absent from the index."""
    h, qp, _, rid, _ = aligner._batch_minimizers(reads)
    B = len(reads)
    rh = np.full((B, MESH_Q), 0xFFFFFFFF, np.uint32)
    rq = np.zeros((B, MESH_Q), np.int32)
    counts = np.bincount(rid, minlength=B)
    starts = np.cumsum(counts) - counts
    for b in range(B):
        n = min(int(counts[b]), MESH_Q)
        rh[b, :n] = h[starts[b]: starts[b] + n]
        rq[b, :n] = qp[starts[b]: starts[b] + n]
    return rh, rq


def check_mesh_step(aligner, reads, dev, card):
    """7a: sharded_align_step on a (1, 1) card mesh, kernel against the
    plain chain DP; returns (launches, max_abs_err)."""
    import torch
    import torch.distributed as dist
    from lr2rmats_tpu_torch.ops import _build
    from lr2rmats_tpu_torch.parallel.distributed import backend
    from lr2rmats_tpu_torch.parallel.mesh import (make_mesh,
                                                  sharded_align_step)
    idx = aligner.index
    if int(idx.hashes.max()) >= 0xFFFFFFFF or int(idx.pos.max()) >= 2**30:
        raise AssertionError("bench index does not fit the mesh step")
    idx_hash = idx.hashes.astype(np.uint32)
    idx_pos = idx.pos.astype(np.int32)
    rh, rq = mesh_reads(aligner, reads)
    dist.init_process_group(backend=backend(),
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, "cuda")
        step = sharded_align_step(mesh, aligner.p.chain, MESH_H)
        plain = sharded_align_step(mesh, aligner.p.chain, MESH_H, plain=True)
        step(idx_hash, idx_pos, rh, rq)             # warm-up
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        with _build.timing() as kernel_ms:
            t0 = time.perf_counter()
            got = step(idx_hash, idx_pos, rh, rq)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        want = plain(idx_hash, idx_pos, rh, rq)
        torch.cuda.synchronize(dev)
        same = torch.equal(got, want)
        fin = want > -1e17
        err = float((got - want)[fin].abs().max()) if bool(fin.any()) \
            else 0.0
        step_ms = cuda_ms(lambda: step(idx_hash, idx_pos, rh, rq), 5)
        plain_ms = cuda_ms(lambda: plain(idx_hash, idx_pos, rh, rq), 1)
    finally:
        dist.destroy_process_group()
    line = {"reads": len(reads), "Q": MESH_Q, "hits_per_seed": MESH_H,
            "anchors_per_read": MESH_Q * MESH_H,
            "index_entries": len(idx_hash), "exact": same,
            "max_abs_err": err, "reads_with_anchors": int(fin.sum()),
            "score_max": float(want.max()),
            "chain_kernel_ms": kernel_ms.get("chain_dp_backtrack", 0.0),
            "step_ms": step_ms, "plain_step_ms": plain_ms,
            "step_wall_s": wall, "launches": launches, "card": card}
    say("multi", "mesh step " + json.dumps(line))
    if not same:
        b = int(torch.nonzero(got != want)[0])
        raise AssertionError(f"mesh step: kernel score {got[b].item()} != "
                             f"plain {want[b].item()} at read {b}")
    if launches["chain_dp_backtrack"] == 0:
        raise AssertionError("the mesh step did not launch the chain kernel")
    return launches, err


def log_launches(path):
    """The kernel launches a pipeline process logged."""
    with open(path) as f:
        for ln in f:
            if "kernel launches {" in ln:
                return json.loads(ln[ln.index("{"):])
    raise AssertionError(f"{path}: no kernel launch line")


def split_fasta(src, dst_a, dst_b):
    """The first half of src's records into dst_a, the rest into dst_b."""
    with open(src) as f:
        lines = f.read().splitlines(keepends=True)
    heads = [i for i, ln in enumerate(lines) if ln.startswith(">")]
    cut = heads[len(heads) // 2]
    for dst, part in ((dst_a, lines[:cut]), (dst_b, lines[cut:])):
        with open(dst, "w") as f:
            f.writelines(part)
    return len(heads) // 2, len(heads) - len(heads) // 2


def gathered_line(path):
    """(payload bytes, seconds) of the gather a pipeline process logged."""
    with open(path) as f:
        for ln in f:
            if "pass-2 GTFs," in ln:
                w = ln.split()
                at = w.index("payload")
                return int(w[at - 1]), float(w[w.index("in", at) + 1])
    raise AssertionError(f"{path}: no gather line")


def run_two_process_pipeline(here, card):
    """7b: phase 6's data as two samples through a 2-process group of the
    port's CLI on the card, against the reference host pipeline on the
    same lists; returns the kernel launches of both processes."""
    from lr2rmats_tpu.pipeline.config import PipelineConfig
    from lr2rmats_tpu_torch._reference import parallel_module
    parallel_module("distributed")   # the reference pipeline imports it
    from lr2rmats_tpu.pipeline.stages import run_pipeline as ref_pipeline
    work = os.path.join(here, "build", "chip_smoke")
    data = os.path.join(work, "data")
    longs = [os.path.join(work, f"long_{t}.fa") for t in "ab"]
    n_reads = split_fasta(os.path.join(data, "long.fa"), *longs)
    long_list = os.path.join(work, "long.list")
    short_list = os.path.join(work, "short.list")
    shorts = f"{data}/short_1.fa {data}/short_2.fa"
    with open(long_list, "w") as f:
        f.write(f"2\n1\n{longs[0]}\n1\n{longs[1]}\n")
    with open(short_list, "w") as f:
        f.write(f"2\n1\n{shorts}\n1\n{shorts}\n")
    genome, gtf = f"{data}/genome.fa", f"{data}/anno.gtf"
    out = os.path.join(work, "multi")
    coord = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": here, **{v: "1" for v in SWITCHES}}
    cmds = [[sys.executable, "-m", "lr2rmats_tpu_torch", "run", "--genome",
             genome, "--gtf", gtf, "--long-read-list", long_list,
             "--short-read-list", short_list, "--out-dir", out,
             "--coordinator", coord, "--num-processes", "2",
             "--process-id", str(pid)] for pid in range(2)]
    walls, _ = run_group(cmds, env, here)
    ref_out = os.path.join(work, "multi_ref")
    cfg = PipelineConfig.from_read_lists(genome, gtf, long_list, short_list)
    cfg.out_dir = ref_out
    t0 = time.perf_counter()
    ref_pipeline(cfg, use_tpu=False)
    ref_s = time.perf_counter() - t0
    got, want = ({f: open(os.path.join(o, "output", f), "rb").read()
                  for f in sorted(os.listdir(os.path.join(o, "output")))}
                 for o in (out, ref_out))
    diff = [k for k in sorted(set(got) | set(want))
            if got.get(k) != want.get(k)]
    if diff or len(want) != 15:
        raise AssertionError(f"2-process pipeline outputs differ from the "
                             f"reference: {diff} ({len(want)} files)")
    logs = [os.path.join(out, "logs", f"pipeline.p{pid}.log")
            for pid in range(2)]
    launches = [log_launches(p) for p in logs]
    gather_b, gather_s = gathered_line(logs[0])
    line = {"long_reads_per_sample": n_reads,
            "process_walls_s": walls, "reference_host_wall_s": ref_s,
            "process_stage_walls_s": stage_walls(out),
            "reference_stage_walls_s": stage_walls(ref_out),
            "gathered_payload_bytes": gather_b, "gather_s": gather_s,
            "launches": launches, "files_identical": sorted(got),
            "card": card}
    say("multi", "pipeline " + json.dumps(line))
    say("multi", f"2-process pipeline {max(walls):.2f} s (reference host, "
        f"one process, {ref_s:.2f} s; not alternated), {len(got)} files "
        f"byte-identical, {gather_b} payload bytes gathered in "
        f"{gather_s:.4f} s")
    for name in ("chain_dp_backtrack", "shift_dp", "combine", "hamming"):
        if not all(la[name] for la in launches):
            raise AssertionError(f"a pipeline process did not launch {name}")
    return launches


_LOOKUP_WORKER = r"""
import json, sys
import numpy as np
import bench
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.parallel.distributed import (end_multihost,
                                                     init_multihost)
from lr2rmats_tpu_torch.parallel.shard_index import ShardedMinimizerIndex
pid, coord, n_reads, n_use, batch, out = sys.argv[1:7]
pid, n_reads, n_use, batch = int(pid), int(n_reads), int(n_use), int(batch)
init_multihost(coord, 2, pid)
rng = np.random.default_rng(%d)
genome = bench.build_genome(int(%r * 1e6), rng)
reads, _ = bench.simulate_reads(genome, n_reads, rng, profile="ont")
idx = ShardedMinimizerIndex.build(genome, 2, local_shard=pid)
al = TorchBatchAligner(genome, index=idx, device="cuda",
                       junction_backend="host", seed_lookup=False)
al.warmup_chain_shapes()
mine = list(range(pid, n_use, 2))
_build.reset_launches()
recs = []
for off in range(0, len(mine), batch):
    part = mine[off: off + batch]
    h = al.dispatch_batch([f"read{i}" for i in part], [reads[i] for i in part])
    recs.extend(al.finish_batch(h))
prim = sorted(r.qname + " " + str(r.pos) + " " +
              " ".join(str(c) for c in r.cigar) for r in recs
              if not (r.flag & 0x100))
with open(f"{out}.{pid}.json", "w") as f:
    json.dump({"primaries": prim, "resident_bytes": idx.resident_bytes(),
               "launches": dict(_build.LAUNCHES),
               "coll_stats": idx.coll_stats}, f)
end_multihost()
""" % (SEED, GENOME_MB)


def run_sharded_lookup(here, genome, full, names, reads, n_reads, card):
    """7c: the 2-process collective lookup on the card against the
    single-process full-index host run; returns both processes'
    launches."""
    from lr2rmats_tpu.align.batch import BatchAligner
    work = os.path.join(here, "build", "chip_smoke")
    out = os.path.join(work, "lookup")
    coord = f"127.0.0.1:{free_port()}"
    n_use = 2 * LOOKUP_READS
    env = {**os.environ, "PYTHONPATH": here}
    walls, _ = run_group([[sys.executable, "-c", _LOOKUP_WORKER, str(pid),
                           coord, str(n_reads), str(n_use),
                           str(LOOKUP_BATCH), out] for pid in range(2)],
                         env, here)
    res = []
    for pid in range(2):
        with open(f"{out}.{pid}.json") as f:
            res.append(json.load(f))
    host = BatchAligner(genome, index=full, backend="host")
    full_bytes = full.hashes.nbytes + full.pos.nbytes + full.strand.nbytes
    for pid in range(2):
        mine = list(range(pid, n_use, 2))
        recs = []
        for off in range(0, len(mine), LOOKUP_BATCH):
            part = mine[off: off + LOOKUP_BATCH]
            recs.extend(host.align_batch([names[i] for i in part],
                                         [reads[i] for i in part]))
        want = sorted(r.qname + " " + str(r.pos) + " " +
                      " ".join(str(c) for c in r.cigar) for r in recs
                      if not (r.flag & 0x100))
        if res[pid]["primaries"] != want:
            raise AssertionError(f"sharded lookup process {pid}: primaries "
                                 "differ from the full-index host run")
        if res[pid]["launches"]["chain_dp_backtrack"] == 0:
            raise AssertionError(f"sharded lookup process {pid} did not "
                                 "launch the chain kernel")
    line = {"reads_per_process": LOOKUP_READS, "batch": LOOKUP_BATCH,
            "process_walls_s": walls,
            "primaries": [len(r["primaries"]) for r in res],
            "resident_index_bytes": [r["resident_bytes"] for r in res],
            "full_index_bytes": full_bytes,
            "coll_stats": [r["coll_stats"] for r in res],
            "launches": [r["launches"] for r in res], "card": card}
    say("multi", "sharded lookup " + json.dumps(line))
    return [r["launches"] for r in res]


def first_diff(a: bytes, b: bytes) -> str:
    la, lb = a.split(b"\n"), b.split(b"\n")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return (f"record {i}:\n  port: {x[:300]!r}\n"
                    f"  host: {y[:300]!r}")
    return f"line counts differ: port {len(la)} vs host {len(lb)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=6144,
                    help="ONT-profile reads to align (default 6144)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import bench
        from lr2rmats_tpu.align.batch import BatchAligner
        from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
        from lr2rmats_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    # 1. device
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; nvidia-smi name, power.limit: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    say("build", f"nvcc sm_90a -> {os.path.relpath(_build.library_path(), here)}"
        f" in {_build.build_info['build_s']:.1f} s (load "
        f"{time.perf_counter() - t0:.1f} s)")
    for line in str(_build.build_info.get("ptxas", "")).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("build", line.strip())

    # workload (bench.py's generator, seed 123)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    genome = bench.build_genome(int(GENOME_MB * 1e6), rng)
    reads, truths = bench.simulate_reads(genome, args.reads, rng,
                                         profile="ont")
    names = [f"read{i}" for i in range(len(reads))]
    seqset = bench._pack(reads, names)
    aligner = TorchBatchAligner(genome, device="cuda",
                                junction_backend="host", seed_lookup=False)
    say("setup", f"{GENOME_MB:g} Mb genome, {len(reads)} ONT reads, index "
        f"built in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    t_phase = time.perf_counter()
    chain_err, chain_t = check_chain(aligner, reads[:1536], dev)
    shift_err, shift_t = check_shift_dp(genome.codes, dev)
    comb_err, comb_t = check_junction(aligner, reads[:1536], dev)
    ham_err, ham_t = check_hamming(genome.codes, dev)
    check_torch_ops(aligner, reads[:1536], dev)
    say("kernels", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    # 4. slice 1: host junctions
    t_phase = time.perf_counter()
    aligner.warmup_chain_shapes()
    aligner.align_batch(names[:64], reads[:64])
    ref = BatchAligner(genome, index=aligner.index, backend="host")
    t0 = time.perf_counter()
    rb_ref = ref.align_seqset_packed(seqset)
    sam_ref = rb_ref.emit_sam(ref.refs)
    ref_wall = time.perf_counter() - t0
    rb, sam, wall, launches, kernel_ms, st, peak_mb = align_slice(
        "slice 1", aligner, seqset, sam_ref, dev)
    for name in ("chain_dp_backtrack", "shift_dp"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by slice 1")
    path_launches = [launches]

    def accuracy(r):
        prim = {a.qname: a for a in r.to_alnrecs() if not (a.flag & 0x100)}
        exact, tp, n_sites = bench.accuracy_vs_truth(truths, names, prim)
        return (len(prim) / len(names), exact / len(names),
                tp / max(n_sites, 1))

    acc, acc_ref = accuracy(rb), accuracy(rb_ref)
    if acc != acc_ref:
        raise AssertionError(f"accuracy differs: port {acc} vs host "
                             f"{acc_ref}")
    kern_total = sum(kernel_ms.values())
    slice_line = {
        "reads": len(reads), "wall_s": wall,
        "reads_per_s": len(reads) / wall,
        "host_backend_wall_s": ref_wall,
        "host_backend_phases_s": {k[:-2]: ref.stats.get(k, 0.0) for k in
                                  ("seed_s", "dispatch_s", "build_s",
                                   "polish_s")},
        "sam_bytes": len(sam), "sam_identical_to_host_backend": True,
        "aligned_frac": acc[0], "exact_exon_chain_frac": acc[1],
        "splice_site_recall": acc[2],
        "kernel_ms": kernel_ms, "kernel_share_of_wall":
            kern_total / 1e3 / wall,
        "launches": launches,
        "host_phases_s": {k[:-2]: st.get(k, 0.0) for k in
                          ("seed_s", "dispatch_s", "build_s", "polish_s")},
        "chain_fetch_wall_s": st["device_wall_s"],
        "anchors_chained": st["anchors"],
        "peak_device_mb": peak_mb,
        "card": card,
    }
    say("slice", json.dumps(slice_line))
    say("slice", f"{len(reads) / wall:.1f} reads/s, SAM identical to the host "
        f"backend ({len(sam)} bytes), exact exon chains {acc[1]:.4f}, splice-"
        f"site recall {acc[2]:.4f}, kernel share {kern_total / 1e3 / wall:.4f}"
        f" of {wall:.2f} s on {card}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")

    # 5. slice 2: device junction DP and device seed lookup
    t_phase = time.perf_counter()
    al2 = TorchBatchAligner(genome, index=aligner.index, device="cuda",
                            junction_backend="device", seed_lookup=True)
    if al2._seed_lookup is None:
        raise AssertionError("the bench index does not take the device "
                             "seed lookup")
    al2.warmup_chain_shapes()
    al2.align_batch(names[:64], reads[:64])
    _, sam2, wall2, launches2, kernel_ms2, st2, peak2 = align_slice(
        "slice 2", al2, seqset, sam_ref, dev)
    for name in ("chain_dp_backtrack", "shift_dp", "combine"):
        if launches2[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by slice 2")
    if st2["seed_lookup_calls"] == 0 or st2["junction_gaps"] == 0:
        raise AssertionError(f"slice 2 did not run its device paths: {st2}")
    path_launches.append(launches2)
    slice2_line = {
        "reads": len(reads), "wall_s": wall2,
        "reads_per_s": len(reads) / wall2,
        "sam_identical_to_host_backend": True,
        "launches": launches2, "kernel_ms": kernel_ms2,
        "kernel_share_of_wall": sum(kernel_ms2.values()) / 1e3 / wall2,
        "junction_calls": st2["junction_calls"],
        "junction_gaps": st2["junction_gaps"],
        "junction_found": st2["junction_found"],
        "seed_lookup_calls": st2["seed_lookup_calls"],
        "device_wall_s": st2["device_wall_s"],
        "host_phases_s": {k[:-2]: st2.get(k, 0.0) for k in
                          ("seed_s", "dispatch_s", "build_s", "polish_s")},
        "peak_device_mb": peak2, "card": card,
    }
    say("slice2", json.dumps(slice2_line))
    say("slice2", f"{len(reads) / wall2:.1f} reads/s with device junctions "
        f"({st2['junction_gaps']} gaps, {st2['junction_found']} placed) and "
        f"device seed lookup ({st2['seed_lookup_calls']} calls); SAM "
        f"identical to the host backend; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")

    # 6. pipeline
    t_phase = time.perf_counter()
    path_launches.append(run_pipeline_phase(here, dev, card))
    say("pipeline", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    # 7. multi-process: mesh step, 2-process pipeline, sharded lookup
    t_phase = time.perf_counter()
    mesh_launches, mesh_err = check_mesh_step(
        aligner, reads[:MESH_READS], dev, card)
    path_launches.append(mesh_launches)
    path_launches.extend(run_two_process_pipeline(here, card))
    path_launches.extend(run_sharded_lookup(here, genome, aligner.index,
                                            names, reads, args.reads, card))
    say("multi", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    total = {k: sum(pl[k] for pl in path_launches) for k in PATH_KERNELS}
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by a "
                                 "slice, pipeline or multi-process phase")

    chain_ms, chain_plain = chain_t[CHAIN_SHAPES[0]]
    shift_ms, shift_plain = shift_t[SHIFT_SHAPES[1][:3]]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "chain_dp_backtrack", "route": "cuda",
         "source": "lr2rmats_tpu_torch/csrc/chain.cu",
         "replaces": "lr2rmats_tpu/ops/chain_pallas.py:39",
         "launches": total["chain_dp_backtrack"],
         "max_abs_err": max(chain_err, mesh_err), "ms": chain_ms,
         "plain_ms": chain_plain},
        {"name": "shift_dp", "route": "cuda",
         "source": "lr2rmats_tpu_torch/csrc/shift_dp.cu",
         "replaces": "lr2rmats_tpu/ops/splice_device.py:295",
         "launches": total["shift_dp"],
         "max_abs_err": shift_err, "ms": shift_ms, "plain_ms": shift_plain},
        {"name": "combine", "route": "cuda",
         "source": "lr2rmats_tpu_torch/csrc/combine.cu",
         "replaces": "lr2rmats_tpu/ops/splice_device.py:152",
         "launches": total["combine"],
         "max_abs_err": comb_err, "ms": comb_t[0], "plain_ms": comb_t[1]},
        {"name": "hamming", "route": "cuda",
         "source": "lr2rmats_tpu_torch/csrc/hamming.cu",
         "replaces": "lr2rmats_tpu/junctions/sjcount_device.py:69",
         "launches": total["hamming"],
         "max_abs_err": ham_err, "ms": ham_t[0], "plain_ms": ham_t[1]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
