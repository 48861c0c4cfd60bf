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
     4, M=64, G=128, and at the junction flank shape (both flanks of the
     first batch's gaps); polish_trace (the placement's split and both
     tracebacks) at band 8, M=192, G=1280 over the card's own S matrices,
     every output word, beside the torch best-split reduction it took off
     the path; the junction kernel (both flank DPs and the
     combine in one launch) on the junction gaps of the first batch plus
     random gaps (G >= 2048), all six outputs; hamming at 131072
     candidates of 150 bases, windows past the buffer end included, then
     reads of 0-301 bases at every offset mod 8 of both buffers; the
     two torch-op ports (seed lookup, junction counts) against their host
     versions, host-clock times beside their bounds; and seed_select (the
     seed hits' expansion, sort, grouping and selection) on a
     GRCh38-shaped batch (diag/seed_batch.py: 1536 reads, ~870 queries
     and ~4400 hits a read), every row and kept anchor, at the full
     budget and at 6000 hits a read;
  4. slice 1: TorchBatchAligner(device="cuda").align_seqset_packed on the
     bench.py workload (lr2rmats_tpu_torch/synth.py, the same bytes: 20 Mb
     genome, ONT profile, seed 123, batch 1536) then emit_sam; the same
     seqset through the port's host backend (BatchAligner, backend "host");
     the SAM bytes and accuracy must be identical;
  5. slice 2: the same with the device junction DP and the device seed
     lookup (junction_backend="device", seed_lookup=True); SAM identical
     to the host backend;
  5b. workers: slices 1 and 2 again with LR2RMATS_SEED_WORKERS=2 and
     LR2RMATS_BUILD_WORKERS=2, slice 2 through LR2RMATS_DEVICE_JUNCTIONS=1
     and LR2RMATS_DEVICE_SEED=1 (the device junction backend keeps one
     build worker); each SAM identical to its one-worker run and to the
     host backend, and the aligner's own counts (chain, junction and
     shift-DP launches, seed lookup calls, junction gaps) equal to its
     one-worker run's;
  6. pipeline: the scripts/simulate.py dataset at its defaults (synth.py:
     12 Mb genome, 200 genes, 20000 long reads, 50000 short pairs, seed
     7), then `python -m lr2rmats_tpu_torch run` (its main, in this
     process) with LR2RMATS_DEVICE_JUNCTIONS=1, LR2RMATS_DEVICE_SEED=1 and
     LR2RMATS_DEVICE_SJCOUNT=1, and the port's `run --cpu` with the three
     switches off; every file under output/, the SAM, the BED and the
     STARSJ table must be byte-identical;
  7. multi-process: (a) a world-1 process group (gloo for the CPU, NCCL for
     the card) and make_mesh(1, 1, "cuda"); sharded_align_step on the bench
     index and the first batch's reads (Q=128 minimizers, 4 hits per seed,
     so 512 anchors per read; its DP is the DP-only kernel) equals the same
     step over the plain chain DP exactly; (b) phase 6's long reads split
     into two samples (halves, each with all short pairs) through two
     `python -m lr2rmats_tpu_torch run` processes of one group on the card
     with the three device switches; updated.gtf and every per-sample
     output equal the port's one-process `run --cpu` (switches off) on the
     same lists; (c) two
     processes, each holding one hash range of the bench index
     (ShardedMinimizerIndex.build(local_shard=pid)), align 768 bench reads
     each in lockstep through the collective lookup with
     TorchBatchAligner(device="cuda"); the primaries equal the
     single-process full-index host backend run.  Both processes of (b) and (c)
     share the one card; their payloads travel over gloo;
  8. the DP-only chain kernel, the diagnostic and the one-process split:
     chain_dp against its plain version, exact, on the first batch's A=128
     rows, on the rows 7a chained (A=512) and on random rows at A=1024
     (B=256) and A=4096 (B=32), and against the fused kernel's f / parent
     where A <= 512; the log probe against its plain version, bit for bit;
     the chain-parity diagnostic (python -m
     lr2rmats_tpu_torch.diag.chain_parity) on the card; the mesh
     step at 8 hits per seed (1024 anchors per read) against the plain
     step, exact; and the bench workload with devices=[cuda:0, cuda:0],
     identical to the unsplit run (on one card this exercises the row
     split, not a second card);
  9. entry points: the functions of the port's measurement entry points at
     reduced sizes: the bench's clean arm (lr2rmats_tpu_torch.bench
     `run_arm`, 1536 reads, one timed pass, SAM and accuracy equal to the
     host backend, exact exon chains 1.0); the ONT accuracy sweep's seed
     123 at its full 1500 reads (`one_seed`: SAM equal to the host
     backend, the fractions equal to ONT_ACCURACY.json); bench_sjcount at
     200000 pairs with the host check (`run(check=True)`; the hamming
     kernel must launch); the GRCh38 dry run's single-process arm at 3 x 4
     Mb chromosomes and 2000 reads (`run_single`: device seed lookup
     checked against the host lookup, SAM equal to the host backend); MAPQ
     calibration's two profiles at 1000 reads each on its 20 Mb genome
     (calibrate_mapq `run_profile`: SAM, recorded reads and margin bins
     equal to the host backend); the ONT failure analysis at 1536 reads
     (analyze_ont_failures `analyze`: SAM equal to the host backend); and
     the scaling script's arms of 1 and 2 processes of `python -m
     lr2rmats_tpu_torch run` on phase 6's data as 4 samples
     (bench_scaling_throughput `run_arms`: every file of output/ equal
     across the arms).  Each of these runs, and the alignment of each
     pipeline process (its aligner's counts, the warm-up apart), must
     launch the chain kernel and shift_dp.
Launch counts are set to 0 before each path run of phases 4-9 (slices,
pipeline, mesh steps, diagnostic) and read after it (the processes of 7b
and 7c start at 0 and report theirs); every kernel must have been launched
by one of them.  Then one JSON line with the kernels,
and the last line {"ok": true, "device": {...}}.  Work files go under
build/chip_smoke/.  Each kernel's entry in the JSON line carries its bound
(bound_ms: the larger of the bytes it must move over the card's memory
rate and the operations these inputs need over its float32 rate,
`bound`) and, where one PyTorch call computes the same function, that
call's time (library_ms).  A kernel's `ms` times 20 calls back to back as
the host issues them (lr2rmats_tpu_torch/diag/measure.py `cuda_ms`), so a
kernel shorter than a wrapper call's Python is timed at the host's launch
rate; its `queued_ms` times the same 20 calls queued behind a spin kernel
(`queued_ms` there), the kernels alone.  The shift_dp entry also lists its
two main-path shapes under "shapes": the polish shape of the entry itself
and the junction flank at the first batch's G, with the flank's own bound.

Neither this script nor the port imports jax or the reference package
lr2rmats_tpu: both are blocked below, here and in the worker processes.
"""

import sys

# any import of jax or of the reference package fails loudly
sys.modules["jax"] = None
sys.modules["lr2rmats_tpu"] = None

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
JUNCTION_MIN_G = 2048
HAMMING_C, HAMMING_L = 131072, 150
HAMMING_EDGE_LENS = (0, 1, 7, 149, 150, 301)
SWITCHES = ("LR2RMATS_DEVICE_JUNCTIONS", "LR2RMATS_DEVICE_SEED",
            "LR2RMATS_DEVICE_SJCOUNT")
PATH_KERNELS = ("chain_dp_backtrack", "chain_dp", "shift_dp", "polish_trace",
                "junction", "hamming", "log_probe", "seed_select")
# the seed selection's batch (diag/seed_batch.py: GRCh38's shape) and the
# small budget that sends its widest reads to the host path
SELECT_SEED, SELECT_SMALL_CAP = 19, 6000
TRACE_G = 1280                                   # polish lanes of a deep call
MESH_READS, MESH_Q, MESH_H, MESH_H_WIDE = 1536, 128, 4, 8
# (A, B, window): random rows at the main path's window 64, and at windows
# 256 and 1024 (the DP-only kernel's rings of 256 and 1024 slots)
CHAIN_DP_RANDOM = ((1024, 256, 64), (4096, 32, 64), (1024, 256, 256),
                   (2048, 64, 1024))
LOOKUP_READS, LOOKUP_BATCH = 768, 256
# phase 9: the entry points' reduced sizes
ENTRY_CLEAN_READS = 1536
ENTRY_SWEEP_SEED = 123
ENTRY_SJ_PAIRS = 200_000
ENTRY_DRYRUN = (3, 4.0, 2000)                    # chromosomes, Mb, reads
ENTRY_CALIBRATE_READS = 1000
ENTRY_ANALYZE_READS = 1536
ENTRY_SCALING_PROCS = (1, 2)
# phase 5b: the seed and build pools the slices run with
WORKERS = {"LR2RMATS_SEED_WORKERS": "2", "LR2RMATS_BUILD_WORKERS": "2"}
# the aligner's own counts that must not move with the pools
WORKER_COUNTS = ("chain_kernel_launches", "junction_kernel_launches",
                 "shift_dp_kernel_launches", "polish_trace_kernel_launches",
                 "seed_lookup_calls",
                 "junction_calls", "junction_gaps", "junction_found")
GROUP_TIMEOUT_S = 300
# the bound of a kernel: the larger of the bytes it must move over the
# H100's HBM rate and the operations its inputs need over the float32 rate
# outside the tensor cores (NVIDIA's data sheet, SXM, 700 W; the integer
# operations of these kernels are counted at the same rate)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# operations per unit of work, counted from each kernel's inner loop
CHAIN_STEP_OPS = 20      # one predecessor step of the chain DP (chain.cu)
SHIFT_CELL_OPS = 9       # one band cell of the shift DP (shift_dp.cu)
# one (j, cl, cr) candidate of the combine with its terms hoisted to
# (j, cl) and (j, cr): two adds, the bonus read, the gate select and the
# argmax compare (junction.cu combine_rows)
JUNCTION_CELL_OPS = 5
# one (j, cl) or (j, cr) entry of the hoisted tables: the hinge's
# subtract and max, and its subtraction from S (junction.cu flank_dp)
JUNCTION_HINGE_OPS = 3
HAMMING_BASE_OPS = 2     # compare and count per base (hamming.cu)
LOG_PROBE_OPS = 2        # log and scale per element (log_probe.cu)


def say(tag, msg):
    print(f"[{tag}] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) of a kernel call moving n_bytes and doing
    n_ops operations."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_steps(n, window: int) -> int:
    """Predecessor steps of the chain DP over rows of n anchors: anchor i
    examines min(i, window) predecessors."""
    n = n.cpu().numpy().astype(np.int64)
    full = np.minimum(n, window)
    return int((full * (full - 1) // 2 + (n - full) * window).sum())


def valid_bytes(n, *rows) -> int:
    """Bytes of the first n[b] entries of row b of each [B, A] tensor: the
    anchors a chain kernel reads."""
    return int(n.long().sum()) * sum(t.element_size() for t in rows)


def sector_bytes(lo, hi) -> int:
    """Bytes of the distinct 32-byte sectors that the half-open ranges
    [lo, hi) touch: the least a gather over them moves from memory."""
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    keep = hi > lo
    lo, hi = lo[keep] // 32, (hi[keep] + 31) // 32
    if not len(lo):
        return 0
    base, size = int(lo.min()), int(hi.max() - lo.min()) + 1
    edges = (np.bincount(lo - base, minlength=size)
             - np.bincount(hi - base, minlength=size))
    return int((np.cumsum(edges)[:-1] > 0).sum()) * 32


def shift_dp_bytes(q, win, m, band, S) -> int:
    """Bytes a shift DP must move: per gap the query rows a finite cell can
    reach (j - 1 < m + 2B) and the window rows (< m + B), m, and all of S."""
    mm = m.long()
    rows_q = int((mm + 2 * band).clamp(max=q.shape[0]).sum())
    rows_w = int((mm + band).clamp(max=win.shape[0]).sum())
    return (rows_q * q.element_size() + rows_w * win.element_size()
            + nbytes(m, S))


def batch_rows(prep, A, C, rng):
    """(qpos, rpos, n, rows of the batch): the first-batch rows of the
    A-anchor chunk, the rest of C rows random."""
    from lr2rmats_tpu_torch.diag.measure import anchor_rows
    real = next((c for c in prep["chunks"] if c[1] == A), None)
    qp, gp, nn = anchor_rows(rng, C, A)
    n_real = 0
    if real is not None:
        n_real = len(real[0])
        qp[:n_real], gp[:n_real], nn[:n_real] = (real[2][:n_real],
                                                 real[3][:n_real],
                                                 real[4][:n_real])
    return qp, gp, nn, n_real


def check_chain(aligner, first_batch, dev):
    """Chain kernel == plain version at the main-path chunk shapes."""
    import torch
    from lr2rmats_tpu_torch.diag.measure import cuda_ms, queued_ms
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
        qp, gp, nn, n_real = batch_rows(prep, A, C, rng)
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
        queued = queued_ms(
            lambda: chain_dp_backtrack(q, g, n, kp, min_score), 20)
        plain_ms = cuda_ms(
            lambda: chain_dp_backtrack_reference(q, g, n, kp, min_score), 2)
        work = (valid_bytes(n, q, g) + nbytes(n, mask, ps, ss),
                CHAIN_STEP_OPS * chain_steps(n, kp.window))
        times[(A, C)] = (ms, queued, plain_ms, *work)
        say("kernels", f"chain_dp_backtrack A={A} B={C}: {n_real} workload "
            f"rows + {C - n_real} random rows, {int(n.sum())} anchors, "
            f"primaries {int((ps > 0).sum())}, secondaries "
            f"{int((ss > 0).sum())}; exact={same} max_abs_err={err} "
            f"kernel {ms:.4f} ms (queued {queued:.4f}), plain "
            f"{plain_ms:.2f} ms")
        if not same:
            bad = (parent != rparent).any(1) | (mask != rmask).any(1) | \
                (ps != rps) | (ss != rss) | (f != rf).any(1)
            b = int(torch.nonzero(bad)[0])
            raise AssertionError(
                f"chain kernel disagrees with the plain version at A={A}, "
                f"row {b}: f {f[b].tolist()} vs {rf[b].tolist()}, parent "
                f"{parent[b].tolist()} vs {rparent[b].tolist()}")
    # on the last shape's rows: the inline cost (STAR's 1M intron cap puts
    # the dd range past the cost table), a refill of the table for other
    # parameters, and the main path's parameters again
    for label, kq in (("max_intron=1000000", kp._replace(max_intron=10**6)),
                      ("gap_scale x2", kp._replace(gap_scale=2 * kp.gap_scale)),
                      ("default", kp)):
        got = chain_dp_backtrack(q, g, n, kq, min_score, dp_out=True)
        want = (*chain_dp_backtrack_reference(q, g, n, kq, min_score),
                *chain_dp_reference(q, g, n, kq))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        say("kernels", f"chain_dp_backtrack A={A} B={C} {label}: "
            f"exact={same}")
        if not same:
            raise AssertionError(f"chain kernel disagrees with the plain "
                                 f"version at {label}")
    return worst, times


def check_shift_dp(genome_codes, dev):
    """Shift-DP kernel == plain version at the main-path shapes."""
    import torch
    from lr2rmats_tpu_torch.diag.measure import cuda_ms, queued_ms
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
        queued = queued_ms(lambda: shift_dp(tq, tw, tm, band), 20)
        plain_ms = cuda_ms(lambda: shift_dp_reference(tq, tw, tm, band), 2)
        cells = int((tm.long() + 1).sum()) * (2 * band + 1)
        times[(band, M, G)] = (ms, queued, plain_ms,
                               shift_dp_bytes(tq, tw, tm, band, got),
                               SHIFT_CELL_OPS * cells)
        say("kernels", f"shift_dp band={band} M={M} G={G} {dt}: exact={same} "
            f"max_abs_err={err} kernel {ms:.4f} ms (queued {queued:.4f}), plain "
            f"{plain_ms:.2f} ms")
        if not same:
            raise AssertionError(f"shift_dp kernel disagrees with the plain "
                                 f"version at band={band} M={M} G={G}")
    return worst, times


def best_pair_torch(SL, SR, m, dl, dr, band):
    """The torch best-split reduction polish ran before polish_trace (the
    score alone: gather, where, max over j), timed beside the kernel."""
    import torch
    M1, W, G = SL.shape
    j = torch.arange(M1, dtype=torch.int64, device=SL.device)[:, None]
    m64, dl64, dr64 = (t.to(torch.int64)[None, :] for t in (m, dl, dr))
    cl = dl64 + band - j
    cr = dr64 + band - (m64 - j)
    okj = (j <= m64) & (cl >= 0) & (cl < W) & (cr >= 0) & (cr < W)
    slj = SL.reshape(M1 * W, G).gather(0, j * W + cl.clamp(0, W - 1))
    mj = (m64 - j).clamp(0, M1 - 1)
    srj = SR.reshape(M1 * W, G).gather(0, mj * W + cr.clamp(0, W - 1))
    neg = torch.tensor(-1e18, dtype=torch.float32, device=SL.device)
    return torch.where(okj, slj + srj, neg).max(0).values


def check_polish_trace(genome_codes, dev):
    """polish_trace == its plain version at the polish shape, every word;
    returns (max_abs_err of the score, (ms, queued, plain_ms, bytes, ops),
    (reduction ms, queued))."""
    import torch
    from lr2rmats_tpu_torch.diag.measure import cuda_ms, queued_ms
    from lr2rmats_tpu_torch.ops.splice import (TRACE_HEAD, polish_trace,
                                               polish_trace_reference,
                                               shift_dp)
    band, M, G = 8, 192, TRACE_G
    rng = np.random.default_rng(SEED + 5)
    arrs = {k: np.full((M + (band if "win" in k else 0), G), -9, np.int8)
            for k in ("q", "qr", "lwin", "rwin")}
    m, dl, dr = (np.zeros(G, np.int32) for _ in range(3))
    n = len(genome_codes)
    for g in range(G):
        mg = int(rng.integers(0, M + 1))
        L0 = int(rng.integers(0, n - 2 * M - 4000))
        R0 = L0 + mg + band + int(rng.integers(0, 3000))
        DL = int(rng.integers(0, mg + band + 1))
        DR = int(np.clip(mg - DL + rng.integers(-band, band + 1), 0,
                         mg + band))
        qw = np.concatenate([genome_codes[L0: L0 + DL],
                             genome_codes[R0 - DR: R0]])[:mg]
        qw = np.concatenate([qw, genome_codes[:mg - len(qw)]]).astype(np.int8)
        mut = rng.random(mg) < 0.08
        qw[mut] = (qw[mut] + 1) % 4
        arrs["q"][:mg, g], arrs["qr"][:mg, g] = qw, qw[::-1]
        arrs["lwin"][:mg + band, g] = genome_codes[L0: L0 + mg + band]
        arrs["rwin"][:mg + band, g] = genome_codes[R0 - mg - band: R0][::-1]
        m[g], dl[g], dr[g] = mg, DL, DR
    t = {k: torch.from_numpy(a).to(dev) for k, a in
         (*arrs.items(), ("m", m), ("dl", dl), ("dr", dr))}
    SL = shift_dp(t["q"], t["lwin"], t["m"], band)
    SR = shift_dp(t["qr"], t["rwin"], t["m"], band)
    args = (SL, SR, t["q"], t["qr"], t["lwin"], t["rwin"], t["m"], t["dl"],
            t["dr"])
    got = polish_trace(*args)
    t0 = time.perf_counter()
    want = polish_trace_reference(*(a.cpu() for a in args))
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = got.cpu()
    same = torch.equal(got, want)
    score = lambda r: r[:, 0].contiguous().view(torch.float32)
    fin = want[:, 1] >= 0
    err = float((score(got) - score(want))[fin].abs().max()) \
        if bool(fin.any()) else 0.0
    red = best_pair_torch(SL, SR, t["m"], t["dl"], t["dr"], band).cpu()
    if not torch.equal(red, score(want)):
        raise AssertionError("polish_trace's score is not the torch "
                             "best-split reduction's")
    ms = cuda_ms(lambda: polish_trace(*args), 20)
    queued = queued_ms(lambda: polish_trace(*args), 20)
    red_ms = cuda_ms(lambda: best_pair_torch(SL, SR, t["m"], t["dl"],
                                             t["dr"], band), 20)
    red_q = queued_ms(lambda: best_pair_torch(SL, SR, t["m"], t["dl"],
                                              t["dr"], band), 20)
    # bytes it needs: m, dl, dr; the two S cells of each split in the band;
    # per walk step three S cells and two code bytes; each row's head and
    # the runs its walks write (the zero padding past them is not needed)
    steps = int((want[:, TRACE_HEAD:].numpy().astype(np.int64) >> 4).sum())
    mm = m.astype(np.int64)
    jj = np.arange(M + 1)[:, None]
    cl = dl[None, :] + band - jj
    cr = dr[None, :] + band - (mm[None, :] - jj)
    splits = int(((jj <= mm) & (cl >= 0) & (cl < 2 * band + 1) & (cr >= 0)
                  & (cr < 2 * band + 1)).sum())
    runs = int(want[:, 4:6].clamp(min=0).sum())
    n_bytes = 12 * G + 8 * splits + 14 * steps + 4 * TRACE_HEAD * G + 4 * runs
    ops = 2 * splits + 8 * steps
    say("kernels", f"polish_trace band={band} M={M} G={G}: exact={same} "
        f"({int(fin.sum())} lanes placed, {steps} walk steps) kernel "
        f"{ms:.4f} ms (queued {queued:.4f}), plain {plain_ms:.1f} ms; the "
        f"torch best-split reduction it replaced {red_ms:.4f} ms (queued "
        f"{red_q:.4f})")
    if not same:
        raise AssertionError("polish_trace disagrees with the plain version")
    return err, (ms, queued, plain_ms, n_bytes, ops), (red_ms, red_q)


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


def junction_work(t, G):
    """(bytes, operations) the junction placement of a batch needs: per gap
    the rows a finite cell reaches of q and qr (R = min(m, M)) and of
    lwin and rwin (R + B), the donor and acceptor classes at offsets <=
    m + 2B, m / span / el / er and the six outputs; nothing for SL / SR,
    which stay on chip.  Operations: both flank DPs over rows 0..m, the
    hinge of each of their (m+1) W cells, and the combine's (m+1) W W
    cells, each counted in the hoisted form."""
    from lr2rmats_tpu_torch.ops.junction import B_DEF
    W = 2 * B_DEF + 1
    M = t["q"].shape[0]
    m = t["m"].long()
    R = m.clamp(min=-1, max=M)
    rows = int((R + 1).sum())
    code_rows = int(2 * R.clamp(min=0).sum() + 2 * (R + B_DEF).clamp(
        min=0).sum())
    class_rows = int(2 * (m + 2 * B_DEF + 1).clamp(
        min=0, max=t["dok"].shape[0]).sum())
    per_gap = sum(t[k].element_size() for k in ("m", "span", "el", "er"))
    out = 4 * 5 + 1
    return (code_rows * 4 + class_rows + G * (per_gap + out),
            (SHIFT_CELL_OPS + JUNCTION_HINGE_OPS) * 2 * rows * W
            + JUNCTION_CELL_OPS * rows * W * W)


def check_junction(aligner, first_batch, dev):
    """The junction kernel (both flank DPs and the combine, one launch)
    == its plain version on all six outputs, and the shift-DP kernel at
    the flank shape == its plain version, on the junction gaps of the
    workload's first batch (the native collect pass of the device
    junction backend) plus random gaps."""
    import torch
    from lr2rmats_tpu_torch.diag.measure import cuda_ms, queued_ms
    from lr2rmats_tpu_torch.native import get_lib
    from lr2rmats_tpu_torch.ops.junction import (B_DEF, junction_place,
                                                 junction_place_reference,
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
    gaps += random_gaps(rng, codes, max(JUNCTION_MIN_G - n_real, 256))
    b = prepare_junction_batch(codes, gaps, B_DEF)
    names = ("q", "qr", "lwin", "rwin", "m", "span", "dok", "aok", "el", "er")
    t = {k: torch.from_numpy(np.ascontiguousarray(b[k])).to(dev)
         for k in names}
    G = len(gaps)
    args = (*(t[k] for k in names), B_DEF, aligner.p.min_intron_len)
    got = junction_place(*args)
    want = junction_place_reference(*args)
    # the flank shape of the shift-DP kernel: no longer on a path, still a
    # shape of that kernel
    flanks = (("q", "lwin"), ("qr", "rwin"))
    S = [shift_dp(t[q], t[w], t["m"], B_DEF) for q, w in flanks]
    S_ref = [shift_dp_reference(t[q], t[w], t["m"], B_DEF)
             for q, w in flanks]
    torch.cuda.synchronize()
    shift_same = all(torch.equal(a, r) for a, r in zip(S, S_ref))
    same = [a.dtype == r.dtype and torch.equal(a, r)
            for a, r in zip(got, want)]
    fin = want[5]
    err = float((got[0] - want[0])[fin].abs().max()) if bool(fin.any()) \
        else 0.0
    both = lambda: [shift_dp(t[q], t[w], t["m"], B_DEF) for q, w in flanks]
    shift_ms = cuda_ms(both, 20) / 2
    shift_queued = queued_ms(both, 20) / 2
    shift_plain = cuda_ms(lambda: [shift_dp_reference(t[q], t[w], t["m"],
                                                      B_DEF)
                                   for q, w in flanks], 1) / 2
    ms = cuda_ms(lambda: junction_place(*args), 20)
    queued = queued_ms(lambda: junction_place(*args), 20)
    plain_ms = cuda_ms(lambda: junction_place_reference(*args), 1)
    say("kernels", f"shift_dp band=4 M=64 G={G} int32 (the junction flank "
        f"shape): exact={shift_same} kernel {shift_ms:.4f} ms (queued "
        f"{shift_queued:.4f}), plain {shift_plain:.2f} ms per flank")
    say("kernels", f"junction G={G}: {n_real} gaps of the first batch + "
        f"{G - n_real} random, found {int(fin.sum())}; exact(score, j, cl, "
        f"cr, vote, found)={same} max_abs_err={err} kernel {ms:.4f} ms "
        f"(queued {queued:.4f}), plain {plain_ms:.2f} ms")
    if not shift_same:
        raise AssertionError("shift_dp disagrees with the plain version at "
                             "the junction flank shape")
    if not all(same):
        bad = torch.zeros(G, dtype=torch.bool, device=dev)
        for a, r in zip(got, want):
            bad |= a != r
        g = int(torch.nonzero(bad)[0])
        raise AssertionError(
            f"junction kernel disagrees with the plain version at gap {g}: "
            f"{[x[g].item() for x in got]} vs {[x[g].item() for x in want]}")
    # one flank's shift DP, as check_shift_dp counts it
    W = 2 * B_DEF + 1
    cells = int((t["m"].long() + 1).sum()) * W
    flank = (shift_ms, shift_queued, shift_plain,
             shift_dp_bytes(t["q"], t["lwin"], t["m"], B_DEF, S[0]),
             SHIFT_CELL_OPS * cells)
    return err, (ms, queued, plain_ms, *junction_work(t, G)), (
        f"band={B_DEF} M={S[0].shape[0] - 1} G={G} int32", flank)


def check_hamming(codes, dev):
    """hamming kernel == plain version: HAMMING_C candidates of
    HAMMING_L-base reads against the genome, 1% past the buffer end."""
    import torch
    from lr2rmats_tpu_torch.diag.measure import cuda_ms, queued_ms
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
    queued = queued_ms(lambda: hamming(*args), 20)
    plain_ms = cuda_ms(lambda: hamming_reference(*args), 2)
    say("kernels", f"hamming C={HAMMING_C} L={HAMMING_L} over a {n}-base "
        f"buffer ({int(past.sum())} windows past its end): exact={same} "
        f"max_abs_err={err} kernel {ms:.4f} ms (queued {queued:.4f}), plain "
        f"{plain_ms:.2f} ms")
    if not same:
        raise AssertionError("hamming kernel disagrees with the plain "
                             "version")
    edge_same = check_hamming_edges(codes, dev)
    say("kernels", f"hamming, reads of {HAMMING_EDGE_LENS} bases at every "
        f"offset mod 8 in the read buffer and in the genome, windows over "
        f"both genome ends, buffers off 4-byte boundaries: exact="
        f"{edge_same}")
    if not edge_same:
        raise AssertionError("hamming kernel disagrees with the plain "
                             "version on the alignment cases")
    # the distinct sectors of the genome windows and of the reads the
    # candidates name, their offsets, rid, pos and the counts
    end = off[rid + 1]
    lo = np.clip(pos, 0, n - 1)
    hi = np.clip(pos + (end - off[rid]) - 1, 0, n - 1) + 1
    work = (sector_bytes(lo, hi) + sector_bytes(off[rid], end)
            + 8 * len(np.union1d(rid, rid + 1)) + nbytes(*args[3:], got),
            HAMMING_BASE_OPS * HAMMING_C * HAMMING_L)
    return err, (ms, queued, plain_ms, *work)


def check_seed_select(dev):
    """seed_select kernel == plain version on a GRCh38-shaped batch (1536
    reads, ~870 queries and ~4400 hits a read): every row description
    and kept anchor, at the full budget and at SELECT_SMALL_CAP hits."""
    import torch
    from lr2rmats_tpu_torch.diag import seed_batch
    from lr2rmats_tpu_torch.diag.measure import cuda_ms, queued_ms
    from lr2rmats_tpu_torch.index.seed_device import (
        SELECT_CAP, seed_select, seed_select_reference)
    b = seed_batch.grch38_like(SELECT_SEED)
    args = seed_batch.args(b, dev)
    rh = np.diff(b["hoff"])
    rest = (seed_batch.K, 200_000, 500, 128)
    same, left = True, {}
    for cap in (SELECT_CAP, SELECT_SMALL_CAP):
        widest = int(rh[rh <= cap].max())
        meta, out = seed_select(*args, *rest, cap=cap, widest=widest)
        pm, po = seed_select_reference(*args, *rest, cap)
        torch.cuda.synchronize()
        n = int(pm[:, 0].clamp(min=0).sum())
        same &= torch.equal(meta, pm) and torch.equal(out[:n], po[:n])
        left[cap] = int((pm[:, 0] < 0).sum())
        if cap == SELECT_CAP:
            kept = n
            widest_full = widest
    run = lambda: seed_select(*args, *rest, widest=widest_full)  # noqa: E731
    ms = cuda_ms(run, 20)
    queued = queued_ms(run, 20)
    plain_ms = cuda_ms(lambda: seed_select_reference(*args, *rest,
                                                     SELECT_CAP), 2)
    say("kernels", f"seed_select {len(rh)} reads, {int(rh.sum())} hits "
        f"({rh.mean():.1f} a read, widest {rh.max()}), {kept} anchors kept "
        f"({kept / len(rh):.1f} a read); reads left to the host "
        f"{left[SELECT_CAP]} at {SELECT_CAP} hits, "
        f"{left[SELECT_SMALL_CAP]} at {SELECT_SMALL_CAP}: exact={same} "
        f"kernel {ms:.4f} ms (queued {queued:.4f}), plain {plain_ms:.2f} ms")
    if not same:
        raise AssertionError("seed_select kernel disagrees with the plain "
                             "version")
    return 0.0, (ms, queued, plain_ms, seed_batch.select_bytes(b, kept), 0)


def check_hamming_edges(codes, dev) -> bool:
    """hamming == plain version where the word path has edges: reads of
    every length of HAMMING_EDGE_LENS starting at every offset mod 8 of
    the read buffer (filler segments of 1-8 bytes between them), each
    against windows at every offset mod 8 of the genome and over both of
    its ends, with both buffers aligned and as views that start one byte
    off a 4-byte boundary (the wrapper copies those)."""
    import torch
    from lr2rmats_tpu_torch.junctions.sjcount_device import (
        hamming, hamming_reference)
    rng = np.random.default_rng(SEED + 6)
    n = len(codes)
    lens = np.repeat(np.array(HAMMING_EDGE_LENS, np.int64), 8)
    fill = np.arange(len(lens)) % 8 + 1
    delim = np.zeros(2 * len(lens) + 1, np.int64)
    np.cumsum(np.stack([lens, fill], 1).reshape(-1), out=delim[1:])
    comb = codes[int(rng.integers(0, n - delim[-1]))
                 + np.arange(delim[-1])].copy()
    per = 14                # 8 offsets mod 8, 3 over the start, 3 the end
    k = np.tile(np.arange(per), len(lens))
    L = np.repeat(lens, per)
    rid = np.repeat(2 * np.arange(len(lens)), per).astype(np.int32)
    pos = rng.integers(1, (n - 400) // 8, len(rid)) * 8 + k
    pos = np.where(k >= 8, np.array([0] * 8 + [-5, 0, 3] + [0] * 3)[k], pos)
    pos = np.where(k >= 11, n - L + np.array([0] * 11 + [-3, 2, 8])[k], pos)
    ok = True
    for shift in (0, 1):
        bb, cb = (torch.from_numpy(np.r_[np.zeros(shift, np.uint8),
                                         a]).to(dev)[shift:]
                  for a in (codes, comb))
        args = [bb, cb, torch.from_numpy(delim).to(dev),
                torch.from_numpy(rid).to(dev),
                torch.from_numpy(pos.astype(np.int64)).to(dev)]
        got = hamming(*args)
        want = hamming_reference(*args)
        torch.cuda.synchronize()
        ok = ok and torch.equal(got, want)
    return ok


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
    # bounds: the lookup reads each query (int32) and writes its two
    # int32 bounds, and must read the table entries that bracket each
    # answer (lo - 1, lo, hi - 1, hi); the counts read each update (int64
    # id, bool, int32 overhang), read and write the three int32 slots of
    # each distinct id, and fetch copies the three tables out
    lo, hi = idx.lookup(h)
    ent = np.concatenate([lo - 1, lo, hi - 1, hi])
    ent = ent[(ent >= 0) & (ent < len(idx.hashes))]
    seed_bound = bound(12 * len(h) + sector_bytes(4 * ent, 4 * ent + 4), 0)
    n_ids = len(np.unique(np.minimum(cc, n)))
    counts_bound = bound(13 * M + 2 * 3 * 4 * n_ids + 3 * 4 * n, 0)
    say("kernels", f"torch ops: seed lookup of {len(h)} hashes exact="
        f"{seed_same} card {seed_t[0]:.2f} ms, host {seed_t[1]:.2f} ms, "
        f"bound {seed_bound[0]:.4f} ms by {seed_bound[1]}; junction counts "
        f"of {M} updates exact={counts_same} card {counts_t[0]:.2f} ms, "
        f"host numpy {counts_t[1]:.2f} ms, bound {counts_bound[0]:.4f} ms "
        f"by {counts_bound[1]} (host clock, copies included)")
    if not (seed_same and counts_same):
        raise AssertionError("a torch-op port disagrees with the host "
                             "version")


def align_slice(tag, aligner, seqset, sam_ref, dev):
    """align_seqset_packed + emit_sam with launch counts and kernel times
    (diag/measure.py `align_pass`); the SAM must equal the host
    backend's."""
    from lr2rmats_tpu_torch.diag.measure import align_pass, first_diff
    p = align_pass(aligner, seqset, dev)
    if sam_ref is not None and p["sam"] != sam_ref:
        raise AssertionError(f"{tag}: SAM bytes differ from the host "
                             "backend: " + first_diff(p["sam"], sam_ref))
    return (p["rb"], p["sam"], p["wall_s"], p["launches"], p["kernel_ms"],
            p["stats"], p["peak_device_mb"])


def run_workers_phase(genome, index, seqset, names, reads, sam_ref, one,
                      dev, card):
    """5b: slices 1 and 2 again with two seed and two build workers
    (WORKERS), slice 2 through the switches in the environment; `one`
    maps "off" / "on" to the one-worker run's (sam, stats, wall).  Each
    SAM must equal the one-worker run's and the host backend's, and the
    aligner's own counts (WORKER_COUNTS) the one-worker run's.  Returns
    the launch counts of both runs."""
    from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
    saved = {v: os.environ.get(v) for v in (*WORKERS, *SWITCHES)}
    out, launches = {}, []
    try:
        for arm in ("off", "on"):
            for v in SWITCHES:
                os.environ.pop(v, None)
            os.environ.update(WORKERS)
            if arm == "on":
                os.environ.update({v: "1" for v in SWITCHES[:2]})
            al = TorchBatchAligner(genome, index=index, device="cuda")
            if (al.junction_backend == "device") != (arm == "on") or \
                    (al._seed_lookup is not None) != (arm == "on"):
                raise AssertionError(f"workers {arm}: the switches did not "
                                     "select the aligner's device paths")
            al.warmup_chain_shapes()
            al.align_batch(names[:64], reads[:64])
            _, sam, wall, la, _, st, _ = align_slice(
                f"workers {arm}", al, seqset, sam_ref, dev)
            sam1, st1, wall1 = one[arm]
            if sam != sam1:
                raise AssertionError(f"workers {arm}: SAM differs from the "
                                     "one-worker run")
            diff = {k: (st.get(k, 0), st1.get(k, 0)) for k in WORKER_COUNTS
                    if st.get(k, 0) != st1.get(k, 0)}
            if diff:
                raise AssertionError(f"workers {arm}: counts (workers, one "
                                     f"worker) differ: {diff}")
            launches.append(la)
            out[arm] = {
                "wall_s": wall, "one_worker_wall_s": wall1,
                "reads_per_s": len(reads) / wall,
                "host_phases_s": {k[:-2]: st.get(k, 0.0) for k in
                                  ("seed_s", "dispatch_s", "build_s",
                                   "polish_s")},
                "one_worker_host_phases_s": {
                    k[:-2]: st1.get(k, 0.0) for k in
                    ("seed_s", "dispatch_s", "build_s", "polish_s")},
                **{k: st.get(k, 0) for k in WORKER_COUNTS}}
            al.close()
    finally:
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
    say("workers", json.dumps({"reads": len(reads), "env": WORKERS,
                               "sam_identical_to_one_worker_and_host_"
                               "backend": True, "arms": out, "card": card}))
    say("workers", "switches off and on: SAM and the aligner's counts equal "
        f"the one-worker runs with {WORKERS}; walls "
        f"{out['off']['wall_s']:.2f} / {out['on']['wall_s']:.2f} s against "
        f"{out['off']['one_worker_wall_s']:.2f} / "
        f"{out['on']['one_worker_wall_s']:.2f} s with one worker each")
    return launches


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


def run_pipeline_phase(here, dev, card):
    """The scripts/simulate.py dataset at its defaults (synth.py); the
    port's CLI with the three device switches on the card; the port's
    `run --cpu` with them off; byte comparison."""
    import torch
    from lr2rmats_tpu_torch.index.minimizer import MinimizerIndex
    from lr2rmats_tpu_torch.io.fasta import Genome
    from lr2rmats_tpu_torch.ops import _build
    from lr2rmats_tpu_torch.pipeline.cli import main as port_main
    from lr2rmats_tpu_torch.scripts.bench_scaling_throughput import \
        stage_walls
    from lr2rmats_tpu_torch.synth import simulate_dataset
    work = os.path.join(here, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    simulate_dataset(data)
    sim_s = time.perf_counter() - t0
    files = {k: os.path.join(data, v) for k, v in (
        ("genome", "genome.fa"), ("gtf", "anno.gtf"), ("long", "long.fa"),
        ("s1", "short_1.fa"), ("s2", "short_2.fa"))}
    # the index both runs load (build_or_load's cache next to the FASTA)
    t0 = time.perf_counter()
    MinimizerIndex.build_or_load(Genome.load(files["genome"]),
                                 files["genome"] + ".tmmi.npz")
    index_s = time.perf_counter() - t0
    say("pipeline", f"simulate.py defaults (synth.py) in {sim_s:.1f} s; "
        f"index built in {index_s:.1f} s")

    def argv(out):
        return ["run", "--genome", files["genome"], "--gtf", files["gtf"],
                "--long-read", files["long"], "--short-read-1", files["s1"],
                "--short-read-2", files["s2"], "--out-dir", out]

    port_out = os.path.join(work, "port")
    os.environ.update({v: "1" for v in SWITCHES})
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    try:
        t0 = time.perf_counter()
        rc = port_main(argv(port_out))
        torch.cuda.synchronize(dev)
        port_s = time.perf_counter() - t0
    finally:
        for v in SWITCHES:
            os.environ.pop(v, None)
    launches = dict(_build.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    if rc != 0:
        raise AssertionError(f"python -m lr2rmats_tpu_torch run exited {rc}")

    cpu_out = os.path.join(work, "cpu")
    t0 = time.perf_counter()
    rc = port_main(argv(cpu_out) + ["--cpu"])
    cpu_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"python -m lr2rmats_tpu_torch run --cpu "
                             f"exited {rc}")

    got, want = pipeline_outputs(port_out), pipeline_outputs(cpu_out)
    diff = [k for k in sorted(set(got) | set(want))
            if got.get(k) != want.get(k)]
    if diff or len(want) != 11:
        raise AssertionError(f"pipeline outputs differ from run --cpu: "
                             f"{diff} ({len(want)} files)")
    line = {"port_wall_s": port_s, "cpu_wall_s": cpu_s,
            "port_stage_walls_s": stage_walls(port_out, 1)[0],
            "cpu_stage_walls_s": stage_walls(cpu_out, 1)[0],
            "launches": launches, "peak_device_mb": peak_mb,
            "files_identical": sorted(got), "bytes": {
                k: len(v) for k, v in got.items()},
            "card": card}
    say("pipeline", json.dumps(line))
    say("pipeline", f"card {port_s:.2f} s (run --cpu {cpu_s:.2f} s), "
        f"{len(got)} files byte-identical, launches {launches}")
    return launches


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


def check_mesh_step(aligner, reads, dev, card, hits):
    """sharded_align_step on a (1, 1) card mesh with `hits` hits per seed,
    kernel against the plain chain DP; returns (launches, max_abs_err,
    chain_dp ms, the anchor rows (qpos, rpos, n) the step chained)."""
    import torch
    import torch.distributed as dist
    from lr2rmats_tpu_torch.diag.measure import cuda_ms
    from lr2rmats_tpu_torch.ops import _build
    from lr2rmats_tpu_torch.parallel import mesh as mesh_mod
    from lr2rmats_tpu_torch.parallel.distributed import backend, free_port
    from lr2rmats_tpu_torch.parallel.mesh import (make_mesh,
                                                  sharded_align_step)
    from lr2rmats_tpu_torch.ops.chain import chain_params_for_kernel
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
        step = sharded_align_step(mesh, aligner.p.chain, hits)
        plain = sharded_align_step(mesh, aligner.p.chain, hits, plain=True)
        rows = []
        real_dp = mesh_mod.chain_dp

        def record(*a):
            rows.append(tuple(t.clone() for t in a[:3]))
            return real_dp(*a)

        mesh_mod.chain_dp = record                  # warm-up, rows kept
        try:
            step(idx_hash, idx_pos, rh, rq)
        finally:
            mesh_mod.chain_dp = real_dp
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
    n_anchor = rows[0][2]
    # the step's bound: the index and read arrays it is given, read once,
    # the scores written once; the chain DP's steps over the valid anchors
    step_bound = bound(
        idx_hash.nbytes + idx_pos.nbytes + rh.nbytes + rq.nbytes
        + 4 * len(rh),
        CHAIN_STEP_OPS * chain_steps(
            n_anchor, chain_params_for_kernel(aligner.p.chain).window))
    line = {"reads": len(reads), "Q": MESH_Q, "hits_per_seed": hits,
            "anchors_per_read": MESH_Q * hits,
            "valid_anchors_max": int(n_anchor.max()),
            "valid_anchors_mean": float(n_anchor.float().mean()),
            "index_entries": len(idx_hash), "exact": same,
            "max_abs_err": err, "reads_with_anchors": int(fin.sum()),
            "score_max": float(want.max()),
            "chain_kernel_ms": kernel_ms.get("chain_dp", 0.0),
            "step_ms": step_ms, "plain_step_ms": plain_ms,
            "step_bound_ms": step_bound[0], "step_bound_by": step_bound[1],
            "step_wall_s": wall, "launches": launches, "card": card}
    say("multi" if hits == MESH_H else "split", "mesh step " +
        json.dumps(line))
    if not same:
        b = int(torch.nonzero(got != want)[0])
        raise AssertionError(f"mesh step: kernel score {got[b].item()} != "
                             f"plain {want[b].item()} at read {b}")
    if launches["chain_dp"] == 0:
        raise AssertionError("the mesh step did not launch chain_dp")
    return launches, err, kernel_ms.get("chain_dp", 0.0), rows[0]


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
    port's CLI on the card, against the port's one-process pipeline on the
    CPU (`run --cpu`, switches off) on the same lists; returns the kernel
    launches of both processes."""
    from lr2rmats_tpu_torch.parallel.distributed import free_port
    from lr2rmats_tpu_torch.pipeline.config import PipelineConfig
    from lr2rmats_tpu_torch.pipeline.stages import run_pipeline
    from lr2rmats_tpu_torch.scripts.bench_scaling_throughput import (
        log_align_launches, log_launches, output_files, stage_walls)
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
    ref_out = os.path.join(work, "multi_cpu")
    cfg = PipelineConfig.from_read_lists(genome, gtf, long_list, short_list)
    cfg.out_dir = ref_out
    t0 = time.perf_counter()
    run_pipeline(cfg, device="cpu")
    ref_s = time.perf_counter() - t0
    got, want = output_files(out), output_files(ref_out)
    diff = [k for k in sorted(set(got) | set(want))
            if got.get(k) != want.get(k)]
    if diff or len(want) != 15:
        raise AssertionError(f"2-process pipeline outputs differ from the "
                             f"one-process CPU run: {diff} ({len(want)} "
                             "files)")
    logs = [os.path.join(out, "logs", f"pipeline.p{pid}.log")
            for pid in range(2)]
    launches = [log_launches(p) for p in logs]
    aligned = [log_align_launches(p) for p in logs]
    gather_b, gather_s = gathered_line(logs[0])
    line = {"long_reads_per_sample": n_reads,
            "process_walls_s": walls, "cpu_one_process_wall_s": ref_s,
            "process_stage_walls_s": stage_walls(out, 2),
            "cpu_stage_walls_s": stage_walls(ref_out, 1)[0],
            "gathered_payload_bytes": gather_b, "gather_s": gather_s,
            "launches": launches, "files_identical": sorted(got),
            "card": card}
    say("multi", "pipeline " + json.dumps(line))
    say("multi", f"2-process pipeline {max(walls):.2f} s (run --cpu, one "
        f"process, {ref_s:.2f} s; not alternated), {len(got)} files "
        f"byte-identical, {gather_b} payload bytes gathered in "
        f"{gather_s:.4f} s")
    for name in ("chain", "shift_dp", "junction"):
        if not all(la[name] for la in aligned):
            raise AssertionError(f"a pipeline process's alignment did not "
                                 f"launch {name}: {aligned}")
    if not all(la["hamming"] for la in launches):
        raise AssertionError("a pipeline process did not launch hamming")
    return launches


_LOOKUP_WORKER = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["lr2rmats_tpu"] = None
import numpy as np
from lr2rmats_tpu_torch import synth
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.parallel.distributed import (end_multihost,
                                                     init_multihost)
from lr2rmats_tpu_torch.parallel.shard_index import ShardedMinimizerIndex
pid, coord, n_reads, n_use, batch, out = sys.argv[1:7]
pid, n_reads, n_use, batch = int(pid), int(n_reads), int(n_use), int(batch)
init_multihost(coord, 2, pid)
rng = np.random.default_rng(%d)
genome = synth.build_genome(int(%r * 1e6), rng)
reads, _ = synth.simulate_reads(genome, n_reads, rng, profile="ont")
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
    single-process full-index host backend run; returns both processes'
    launches."""
    from lr2rmats_tpu_torch.align.batch import BatchAligner
    from lr2rmats_tpu_torch.parallel.distributed import free_port
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
    host = BatchAligner(genome, index=full)
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


def check_chain_dp(aligner, first_batch, mesh_rows, dev):
    """8: chain_dp == its plain version on the first batch's A=128 rows
    (phase 3's chunk), the rows 7a chained and random rows at
    CHAIN_DP_RANDOM, and == the fused kernel's f / parent where A <=
    K_MAX_A; prints each shape's time a step of its widest row, in ns and
    in cycles at the SM clock read beside the run; returns (max_abs_err,
    {label: (ms, queued_ms, plain_ms, bytes, ops)})."""
    import torch
    from lr2rmats_tpu_torch.align.chain import ChainParams
    from lr2rmats_tpu_torch.diag.measure import (anchor_rows, cuda_ms,
                                                 queued_ms, sm_clock_mhz)
    from lr2rmats_tpu_torch.ops.chain import (K_MAX_A, chain_dp,
                                              chain_dp_backtrack,
                                              chain_dp_reference,
                                              chain_params_for_kernel)
    kp0 = chain_params_for_kernel(aligner.p.chain)
    prep = aligner._prepare_dispatch(aligner._batch_anchors(first_batch))
    rng = np.random.default_rng(SEED)
    A0, C0 = CHAIN_SHAPES[0]
    qp, gp, nn, n_real = batch_rows(prep, A0, C0, rng)
    cases = [(f"first batch A={A0} B={C0} ({n_real} workload rows)",
              (qp, gp, nn), kp0)]
    mq, mg, mn = (t.cpu().numpy() for t in mesh_rows)
    cases.append((f"7a mesh rows A={mq.shape[1]} B={len(mn)}", (mq, mg, mn),
                  kp0))
    rng = np.random.default_rng(SEED + 5)
    for A, B, window in CHAIN_DP_RANDOM:
        kp = kp0 if window == kp0.window else chain_params_for_kernel(
            ChainParams(window=window))
        cases.append((f"random A={A} B={B} window={window}",
                      anchor_rows(rng, B, A), kp))
    mhz = sm_clock_mhz(dev)
    say("dp", f"SM clock under load (nvidia-smi clocks.sm): {mhz:.0f} MHz")
    worst, times = 0.0, {}
    for label, arrays, kp in cases:
        q, g, n = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in arrays)
        A = q.shape[1]
        f, parent = chain_dp(q, g, n, kp)
        rf, rparent = chain_dp_reference(q, g, n, kp)
        torch.cuda.synchronize(dev)
        valid = torch.arange(A, device=dev)[None, :] < n[:, None]
        err = float((f - rf)[valid].abs().max()) if bool(valid.any()) \
            else 0.0
        worst = max(worst, err)
        same = torch.equal(f, rf) and torch.equal(parent, rparent)
        fused = "not run (A > 512, the fused kernel's cap)"
        fused_same = True
        if A <= K_MAX_A:
            ff, fparent = chain_dp_backtrack(q, g, n, kp, aligner.p.min_score,
                                             dp_out=True)[3:]
            fused_same = torch.equal(f, ff) and torch.equal(parent, fparent)
            fused = str(fused_same)
        ms = cuda_ms(lambda: chain_dp(q, g, n, kp), 20)
        queued = queued_ms(lambda: chain_dp(q, g, n, kp), 20)
        plain_ms = cuda_ms(lambda: chain_dp_reference(q, g, n, kp), 1)
        times[label] = (ms, queued, plain_ms,
                        valid_bytes(n, q, g) + nbytes(n, f, parent),
                        CHAIN_STEP_OPS * chain_steps(n, kp.window))
        widest = max(int(n.max()), 1)
        step_ns = queued * 1e6 / widest
        say("dp", f"chain_dp {label}: {int(n.sum())} anchors (widest row "
            f"{int(n.max())}); exact vs plain={same} max_abs_err={err}; "
            f"f / parent equal to chain_dp_backtrack: {fused}; kernel "
            f"{ms:.4f} ms (queued {queued:.4f}), plain {plain_ms:.2f} ms; "
            f"widest row's step {step_ns:.1f} ns = "
            f"{step_ns * mhz / 1e3:.0f} cycles at {mhz:.0f} MHz")
        if not (same and fused_same):
            bad = (f != rf).any(1) | (parent != rparent).any(1)
            b = int(torch.nonzero(bad)[0]) if bool(bad.any()) else -1
            raise AssertionError(f"chain_dp disagrees ({label}) at row {b}")
    return worst, times


def check_log_probe(dev):
    """8: the log probe kernel == its plain version, bit for bit, over the
    diagnostic's sample; returns (max_abs_err, (ms, queued_ms, plain_ms,
    bytes, ops, and the times of the PyTorch call torch.log(x) * LOG2E
    back to back and queued))."""
    import torch
    from lr2rmats_tpu_torch.diag.measure import (cuda_ms, launch_floor_ms,
                                                 queued_ms)
    from lr2rmats_tpu_torch.diag.chain_parity import (LOG2E, log_probe,
                                                      log_probe_reference,
                                                      probe_sample)
    from lr2rmats_tpu_torch.ops import _build
    x = torch.from_numpy(probe_sample()[1]).to(dev)
    y, want = log_probe(x), log_probe_reference(x)
    same = torch.equal(y, want)
    fin = torch.isfinite(want)       # the zero padding gives -inf in both
    err = float((y - want)[fin].abs().max())
    ms = cuda_ms(lambda: log_probe(x), 20)
    queued = queued_ms(lambda: log_probe(x), 20)
    plain_ms = cuda_ms(lambda: log_probe_reference(x), 20)
    with _build.timing() as ev:     # events on the stream around each launch
        for _ in range(20):
            log_probe(x)
    say("diag", f"log_probe x [{x.shape[0]}, {x.shape[1]}]: exact={same} "
        f"max_abs_err={err} kernel {ms:.4f} ms (queued {queued:.4f}), "
        f"plain {plain_ms:.4f} ms "
        f"(20 back-to-back calls each; between the events around each "
        f"launch {ev['log_probe'] / 20:.4f} ms)")
    lib_ms = cuda_ms(lambda: torch.log(x) * LOG2E, 20)
    lib_queued = queued_ms(lambda: torch.log(x) * LOG2E, 20)
    floor = launch_floor_ms(dev)
    bound_ms, bound_by = bound(nbytes(x, y), LOG_PROBE_OPS * x.numel())
    say("diag", f"log_probe: torch.log(x) * LOG2E {lib_ms:.4f} ms (queued "
        f"{lib_queued:.4f}) against the kernel's {ms:.4f} (queued "
        f"{queued:.4f}); launch floor (t.add_(0) on one element, queued) "
        f"{floor:.4f} ms; bound {bound_ms:.5f} ms by {bound_by}")
    odd = x.reshape(-1)[1:]         # 4 bytes off 16-byte alignment
    odd_same = torch.equal(log_probe(odd), log_probe_reference(odd))
    say("diag", f"log_probe on x[1:] ({odd.numel()} values, 4 bytes off "
        f"16-byte alignment): exact={odd_same}")
    if not (same and odd_same):
        raise AssertionError("log_probe disagrees with its plain version")
    return err, (ms, queued, plain_ms, nbytes(x, y),
                 LOG_PROBE_OPS * x.numel(), lib_ms, lib_queued, floor)


def run_diag(dev):
    """8: `python -m lr2rmats_tpu_torch.diag.chain_parity` on the card (its
    main, in this process); returns its kernel launches."""
    from lr2rmats_tpu_torch.diag import chain_parity
    from lr2rmats_tpu_torch.ops import _build
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = chain_parity.main(["--device", "cuda"])
    launches = dict(_build.LAUNCHES)
    say("diag", f"chain_parity exited {rc} in {time.perf_counter() - t0:.1f} "
        f"s; launches {launches}")
    if rc != 0 or not (launches["chain_dp"] and launches["log_probe"]):
        raise AssertionError("the chain-parity diagnostic failed")
    return launches


def run_entry_points(here, dev):
    """9: the measurement entry points' functions at reduced sizes, each
    with its own guard; returns the launches of each run and of each
    pipeline process."""
    from lr2rmats_tpu_torch import bench
    from lr2rmats_tpu_torch.ops import _build
    from lr2rmats_tpu_torch.scripts import (analyze_ont_failures,
                                            bench_sjcount, calibrate_mapq,
                                            dryrun_grch38)
    from lr2rmats_tpu_torch.scripts import bench_scaling_throughput as scaling
    from lr2rmats_tpu_torch.scripts import ont_accuracy_sweep as sweep
    runs = []

    def counted(fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        runs.append(dict(_build.LAUNCHES))
        return out, time.perf_counter() - t0

    arm, t = counted(lambda: bench.run_arm(GENOME_MB, ENTRY_CLEAN_READS,
                                           None, 1, dev))
    if arm["exact_exon_chain_frac"] != 1.0 or not runs[-1]["shift_dp"]:
        raise AssertionError(f"bench clean arm: exact exon chains "
                             f"{arm['exact_exon_chain_frac']}, launches "
                             f"{runs[-1]}")
    say("entry", f"bench clean arm ({t:.1f} s): " + json.dumps(
        {k: arm[k] for k in ("n_reads", "reads_per_sec", "align_wall_s",
                             "exact_exon_chain_frac", "idle_share",
                             "launches", "kernel_ms", "peak_device_mb",
                             "host_backend_wall_s", "setup_s")}))
    want = sweep.expected(sweep.EXPECT, sweep.N_READS, sweep.GENOME_MB)
    row, t = counted(lambda: sweep.one_seed(ENTRY_SWEEP_SEED, dev))
    got = (row["exact_exon_chain_frac"], row["splice_site_recall"])
    if want is None or got != want[ENTRY_SWEEP_SEED]:
        raise AssertionError(f"sweep seed {ENTRY_SWEEP_SEED}: {got} against "
                             f"ONT_ACCURACY.json's "
                             f"{want and want[ENTRY_SWEEP_SEED]}")
    say("entry", f"sweep seed {ENTRY_SWEEP_SEED} ({t:.1f} s, "
        f"{sweep.N_READS} reads): {got} as in ONT_ACCURACY.json; "
        + json.dumps(row))
    sj, t = counted(lambda: bench_sjcount.run(ENTRY_SJ_PAIRS, device=dev,
                                              check=True))
    if not sj["detail"]["hamming_launches"]:
        raise AssertionError("bench_sjcount did not launch the hamming "
                             "kernel")
    say("entry", f"bench_sjcount ({t:.1f} s): counts equal to the host "
        "backend's; " + json.dumps(sj))
    dry, t = counted(lambda: dryrun_grch38.run_single(dev, *ENTRY_DRYRUN))
    if not (runs[-1]["chain_dp_backtrack"] and dry["seed_lookup_calls"]):
        raise AssertionError(f"dry run: launches {runs[-1]}, seed lookups "
                             f"{dry['seed_lookup_calls']}")
    say("entry", f"dry run ({t:.1f} s): SAM equal to the host backend; "
        + json.dumps(dry))

    def main_path(tag, launches):
        if not (launches["chain_dp_backtrack"] and launches["shift_dp"]):
            raise AssertionError(f"{tag}: launches {launches}")

    for profile, seed in calibrate_mapq.PROFILES:
        (rows, _, cal), t = counted(lambda: calibrate_mapq.run_profile(
            profile, ENTRY_CALIBRATE_READS, seed, dev))
        main_path(f"calibrate_mapq {cal['profile']}", runs[-1])
        say("entry", f"calibrate_mapq {cal['profile']} ({t:.1f} s, "
            f"{len(rows)} primaries): SAM, recorded reads and margin bins "
            "equal to the host backend; " + json.dumps(cal))
    (_, fail), t = counted(lambda: analyze_ont_failures.analyze(
        ENTRY_ANALYZE_READS, dev))
    main_path("analyze_ont_failures", runs[-1])
    say("entry", f"analyze_ont_failures ({t:.1f} s): SAM equal to the host "
        "backend; " + json.dumps(fail))
    work = os.path.join(here, "build", "chip_smoke")
    t0 = time.perf_counter()
    sc = scaling.run_arms(os.path.join(work, "data"),
                          os.path.join(work, "scaling"),
                          list(ENTRY_SCALING_PROCS), "cuda")
    for nproc, arm in sc["arms"].items():
        for pid, proc in enumerate(arm["processes"]):
            al = proc["align_launches"]
            if not (al["chain"] and al["shift_dp"]) or \
                    proc["launches"]["chain_dp"]:
                raise AssertionError(f"scaling arm {nproc}, process {pid}: "
                                     f"alignment launches {al}, all "
                                     f"{proc['launches']}")
            runs.append(proc["launches"])
    say("entry", f"scaling arms {list(ENTRY_SCALING_PROCS)} "
        f"({time.perf_counter() - t0:.1f} s): output/ identical across the "
        "arms; " + json.dumps(sc))
    return runs


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
        from lr2rmats_tpu_torch import synth
        from lr2rmats_tpu_torch.align.batch import (BatchAligner,
                                                    TorchBatchAligner)
        from lr2rmats_tpu_torch.diag.measure import card_line
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

    # workload (bench.py's generator, in synth.py; seed 123)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    genome = synth.build_genome(int(GENOME_MB * 1e6), rng)
    reads, truths = synth.simulate_reads(genome, args.reads, rng,
                                         profile="ont")
    names = [f"read{i}" for i in range(len(reads))]
    seqset = synth.pack_seqset(reads, names)
    aligner = TorchBatchAligner(genome, device="cuda",
                                junction_backend="host", seed_lookup=False)
    say("setup", f"{GENOME_MB:g} Mb genome, {len(reads)} ONT reads, index "
        f"built in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    t_phase = time.perf_counter()
    chain_err, chain_t = check_chain(aligner, reads[:1536], dev)
    shift_err, shift_t = check_shift_dp(genome.codes, dev)
    trace_err, trace_t, trace_red = check_polish_trace(genome.codes, dev)
    junc_err, junc_t, (flank_shape, flank_t) = check_junction(
        aligner, reads[:1536], dev)
    ham_err, ham_t = check_hamming(genome.codes, dev)
    check_torch_ops(aligner, reads[:1536], dev)
    select_err, select_t = check_seed_select(dev)
    say("kernels", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    # 4. slice 1: host junctions
    t_phase = time.perf_counter()
    aligner.warmup_chain_shapes()
    aligner.align_batch(names[:64], reads[:64])
    ref = BatchAligner(genome, index=aligner.index)
    t0 = time.perf_counter()
    rb_ref = ref.align_seqset_packed(seqset)
    sam_ref = rb_ref.emit_sam(ref.refs)
    ref_wall = time.perf_counter() - t0
    rb, sam, wall, launches, kernel_ms, st, peak_mb = align_slice(
        "slice 1", aligner, seqset, sam_ref, dev)
    for name in ("chain_dp_backtrack", "shift_dp", "polish_trace"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by slice 1")
    path_launches = [launches]

    def accuracy(r):
        prim = {a.qname: a for a in r.to_alnrecs() if not (a.flag & 0x100)}
        exact, tp, n_sites = synth.accuracy_vs_truth(truths, names, prim)
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
    for name in ("chain_dp_backtrack", "shift_dp", "junction"):
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

    # 5b. slices 1 and 2 with two seed and two build workers
    t_phase = time.perf_counter()
    path_launches.extend(run_workers_phase(
        genome, aligner.index, seqset, names, reads, sam_ref,
        {"off": (sam, st, wall), "on": (sam2, st2, wall2)}, dev, card))
    say("workers", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    # 6. pipeline
    t_phase = time.perf_counter()
    path_launches.append(run_pipeline_phase(here, dev, card))
    say("pipeline", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    # 7. multi-process: mesh step, 2-process pipeline, sharded lookup
    t_phase = time.perf_counter()
    mesh_launches, mesh_err, _, mesh_rows = check_mesh_step(
        aligner, reads[:MESH_READS], dev, card, MESH_H)
    path_launches.append(mesh_launches)
    path_launches.extend(run_two_process_pipeline(here, card))
    path_launches.extend(run_sharded_lookup(here, genome, aligner.index,
                                            names, reads, args.reads, card))
    say("multi", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    # 8. DP-only chain kernel, diagnostic, wide mesh step, split
    t_phase = time.perf_counter()
    dp_err, dp_t = check_chain_dp(aligner, reads[:1536], mesh_rows, dev)
    probe_err, probe_t = check_log_probe(dev)
    path_launches.append(run_diag(dev))
    wide_launches, wide_err, _, _ = check_mesh_step(
        aligner, reads[:MESH_READS], dev, card, MESH_H_WIDE)
    path_launches.append(wide_launches)
    al_s = TorchBatchAligner(genome, index=aligner.index, device="cuda",
                             junction_backend="host", seed_lookup=False,
                             devices=[dev, dev])
    al_s.warmup_chain_shapes()
    al_s.align_batch(names[:64], reads[:64])
    _, _, wall_s, launches_s, _, _, _ = align_slice(
        "slice split", al_s, seqset, sam_ref, dev)
    if launches_s["chain_dp_backtrack"] != \
            2 * launches["chain_dp_backtrack"]:
        raise AssertionError(f"the split slice launched {launches_s}, not "
                             "twice slice 1's chain launches")
    path_launches.append(launches_s)
    say("split", f"bench slice with devices=[{dev}, {dev}]: SAM identical "
        f"to the host backend and to slice 1; chain launches "
        f"{launches_s['chain_dp_backtrack']} = 2 x slice 1's "
        f"{launches['chain_dp_backtrack']}; {len(reads) / wall_s:.1f} "
        f"reads/s (one card twice: this exercises the row split, not a "
        f"second card)")
    say("split", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    # 9. the measurement entry points
    t_phase = time.perf_counter()
    path_launches.extend(run_entry_points(here, dev))
    say("entry", f"phase wall {time.perf_counter() - t_phase:.1f} s")

    total = {k: sum(pl.get(k, 0) for pl in path_launches)
             for k in PATH_KERNELS}
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched by a "
                                 "path run of phases 4-9")

    def entry(name, source, replaces, err, t, lib_ms=None, lib_queued=None):
        """One kernel of the JSON line; t = (ms, queued_ms, plain_ms, bytes,
        ops)."""
        bound_ms, bound_by = bound(t[3], t[4])
        return {"name": name, "route": "cuda",
                "source": f"lr2rmats_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": total[name],
                "max_abs_err": err, "ms": t[0], "queued_ms": t[1],
                "plain_ms": t[2], "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": t[3], "operations": t[4], "library_ms": lib_ms,
                "library_queued_ms": lib_queued}

    kernels = [
        entry("chain_dp_backtrack", "chain.cu",
              "lr2rmats_tpu/ops/chain_pallas.py:39", chain_err,
              chain_t[CHAIN_SHAPES[0]]),
        entry("chain_dp", "chain.cu", "lr2rmats_tpu/ops/chain_pallas.py:39",
              max(dp_err, mesh_err, wide_err),
              next(iter(dp_t.values()))),          # first batch, A=128
        entry("shift_dp", "shift_dp.cu",
              "lr2rmats_tpu/ops/splice_device.py:295", shift_err,
              shift_t[SHIFT_SHAPES[1][:3]]),
        entry("polish_trace", "shift_dp.cu",
              "none: the host re-run of lr2rmats_tpu/align/polish.py "
              "polish_batch's deferred _constrained_place; off the path: "
              "the torch best-split reduction", trace_err, trace_t),
        entry("junction", "junction.cu",
              "lr2rmats_tpu/ops/splice_device.py:260 (_junction_scan: :295 "
              "_dp_kernel x2 + :152 _combine)", junc_err, junc_t),
        entry("hamming", "hamming.cu",
              "lr2rmats_tpu/junctions/sjcount_device.py:69", ham_err, ham_t),
        entry("log_probe", "log_probe.cu", "scripts/diag_chain_pallas.py:98",
              probe_err, probe_t[:5], lib_ms=probe_t[5],
              lib_queued=probe_t[6]),
        entry("seed_select", "seed_select.cu",
              "none: the host expansion, sort and grouping of the lookup's "
              "hits (lr2rmats_tpu/align/batch.py _batch_anchors)",
              select_err, select_t),
    ]
    kernels[6]["launch_floor_queued_ms"] = probe_t[7]
    kernels[3]["replaced_reduction_ms"] = trace_red[0]
    kernels[3]["replaced_reduction_queued_ms"] = trace_red[1]
    # the junction flanks' shift DP: a second shape of the shift_dp entry
    flank_bound, flank_by = bound(flank_t[3], flank_t[4])
    polish_t = shift_t[SHIFT_SHAPES[1][:3]]
    kernels[2]["shapes"] = [
        {"shape": "band={} M={} G={} int8 (polish)".format(*SHIFT_SHAPES[1]),
         "ms": polish_t[0], "queued_ms": polish_t[1]},
        {"shape": f"{flank_shape} (junction flank)", "ms": flank_t[0],
         "queued_ms": flank_t[1], "plain_ms": flank_t[2],
         "bound_ms": flank_bound, "bound_by": flank_by, "bytes": flank_t[3],
         "operations": flank_t[4]}]
    for k in kernels:
        say("bound", f"{k['name']}: {k['ms']:.4f} ms (queued "
            f"{k['queued_ms']:.4f}) against a bound of {k['bound_ms']:.4f} "
            f"ms by {k['bound_by']} ({k['bytes']} bytes, {k['operations']} "
            f"operations) on {card}")
    say("bound", f"shift_dp junction flank {flank_shape}: {flank_t[0]:.4f} "
        f"ms (queued {flank_t[1]:.4f}) against a bound of {flank_bound:.4f} "
        f"ms by {flank_by} ({flank_t[3]} bytes, {flank_t[4]} operations) on "
        f"{card}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
