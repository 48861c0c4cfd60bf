#!/usr/bin/env python3
"""Smoke test of lr2rmats_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:

    python3 chip_smoke.py                 # bench workload, 6144 ONT reads
    python3 chip_smoke.py --reads 100000  # larger run

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: requires torch.cuda.is_available(); prints nvidia-smi's name
     and power limit of the card;
  2. build: compiles the CUDA kernels from lr2rmats_tpu_torch/csrc with
     nvcc for sm_90a and prints the build time and ptxas report;
  3. kernels: each kernel against its plain PyTorch version on the card at
     main-path shapes (chain at A=128/B=1664 and A=64/B=320 on anchor rows
     of the workload's first batch plus random rows; shift DP at band 8,
     M=192, G=256/512 and band 4, M=64, G=128), exact, with CUDA-event
     times of both;
  4. slice: TorchBatchAligner(device="cuda").align_seqset_packed on the
     bench.py workload (20 Mb genome, ONT profile, seed 123, batch 1536)
     then emit_sam; the same seqset through the reference package's host
     backend (BatchAligner(backend="host"), which imports no jax); the SAM
     bytes and accuracy must be identical and both kernels must have been
     launched by the slice.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}.

Neither this script nor the port imports jax: it is blocked below.
"""

import sys

sys.modules["jax"] = None  # any jax import in the slice fails loudly

import argparse
import json
import os
import subprocess
import time

import numpy as np

SEED = 123
GENOME_MB = 20.0
CHAIN_SHAPES = ((128, 1664), (64, 320))          # (A, chunk rows)
SHIFT_SHAPES = ((8, 192, 256, "int8"), (8, 192, 512, "int8"),
                (4, 64, 128, "int32"))           # (band, M, G, dtype)


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
    aligner = TorchBatchAligner(genome, device="cuda")
    say("setup", f"{GENOME_MB:g} Mb genome, {len(reads)} ONT reads, index "
        f"built in {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    chain_err, chain_t = check_chain(aligner, reads[:1536], dev)
    shift_err, shift_t = check_shift_dp(genome.codes, dev)

    # 4. the slice
    aligner.warmup_chain_shapes()
    aligner.align_batch(names[:64], reads[:64])
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
    st = dict(aligner.stats)
    for name, cnt in launches.items():
        if cnt == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "slice")
    ref = BatchAligner(genome, index=aligner.index, backend="host")
    t0 = time.perf_counter()
    rb_ref = ref.align_seqset_packed(seqset)
    sam_ref = rb_ref.emit_sam(ref.refs)
    ref_wall = time.perf_counter() - t0
    if sam != sam_ref:
        raise AssertionError("SAM bytes differ from the host backend: "
                             + first_diff(sam, sam_ref))

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
        "peak_device_mb": torch.cuda.max_memory_allocated(dev) / 2**20,
        "card": card,
    }
    say("slice", json.dumps(slice_line))
    say("slice", f"{len(reads) / wall:.1f} reads/s, SAM identical to the host "
        f"backend ({len(sam)} bytes), exact exon chains {acc[1]:.4f}, splice-"
        f"site recall {acc[2]:.4f}, kernel share {kern_total / 1e3 / wall:.4f}"
        f" of {wall:.2f} s on {card}")

    chain_ms, chain_plain = chain_t[CHAIN_SHAPES[0]]
    shift_ms, shift_plain = shift_t[SHIFT_SHAPES[1][:3]]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "chain_dp_backtrack", "route": "cuda",
         "source": "lr2rmats_tpu_torch/csrc/chain.cu",
         "replaces": "lr2rmats_tpu/ops/chain_pallas.py:39",
         "launches": launches["chain_dp_backtrack"],
         "max_abs_err": chain_err, "ms": chain_ms, "plain_ms": chain_plain},
        {"name": "shift_dp", "route": "cuda",
         "source": "lr2rmats_tpu_torch/csrc/shift_dp.cu",
         "replaces": "lr2rmats_tpu/ops/splice_device.py:295",
         "launches": launches["shift_dp"],
         "max_abs_err": shift_err, "ms": shift_ms, "plain_ms": shift_plain},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
