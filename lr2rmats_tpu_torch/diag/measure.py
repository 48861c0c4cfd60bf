"""What chip_smoke.py, `diag/kernel_variants.py` and the measurement entry
points share: card timers, random anchor rows, the timed alignment pass,
the card's name line and the guard's error.

Two timers, both over CUDA events around `reps` calls after a warm-up call:
`cuda_ms` times the calls back to back as the host issues them, so a
kernel shorter than a call's Python is timed at the host's launch rate;
`queued_ms` first queues a spin kernel (~5 ms) so that the calls' kernels
wait behind it and run back to back, and times the kernels alone.
`launch_floor_ms` is the queued time of the least a launch can do (one
PyTorch op on one element); `sm_clock_mhz` reads the SM clock while the
card is busy, to turn a step time into cycles.  `align_pass` runs one
`align_seqset_packed` + `emit_sam` pass of an aligner with each kernel's
launches and CUDA-event time: the accounting of chip_smoke.py's slices and
of `lr2rmats_tpu_torch.bench`.
"""

from __future__ import annotations

import time

import numpy as np

SPIN_CYCLES = 10_000_000  # the spin kernel of queued_ms, ~5 ms on an H100


class GuardError(RuntimeError):
    """An output of the card path differs from the host backend's, or an
    accuracy differs from its recorded value."""


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (first card)."""
    import subprocess
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_detail(dev) -> dict:
    """What a result line names its device by: `platform` ("gpu" or
    "cpu"), `device` (torch's name of the card, or "cpu") and `card`
    (`card_line()`, None on the CPU)."""
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "device": "cpu", "card": None}
    return {"platform": "gpu", "device": torch.cuda.get_device_name(dev),
            "card": card_line()}


def host_detail() -> dict:
    """What a host-only entry point's line names its machine by: the
    host's core count and `card_line()` (None where nvidia-smi is
    missing)."""
    import os
    import shutil
    return {"platform": "cpu", "cores": os.cpu_count(),
            "card": card_line() if shutil.which("nvidia-smi") else None}


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps back-to-back calls."""
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


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of the kernels of reps calls of fn(),
    queued behind a spin kernel so that they run back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def launch_floor_ms(dev, reps: int = 20) -> float:
    """queued_ms of `t.add_(0)` on a one-element float32 tensor on `dev`:
    the floor under any kernel's queued time."""
    import torch
    t = torch.zeros(1, dtype=torch.float32, device=dev)
    return queued_ms(lambda: t.add_(0), reps)


def sm_clock_mhz(dev) -> float:
    """The SM clock (MHz) that `nvidia-smi --query-gpu=clocks.sm` reads
    while a spin kernel (~0.3 s) keeps the card busy."""
    import subprocess

    import torch
    with torch.cuda.device(dev):
        torch.cuda._sleep(60 * SPIN_CYCLES)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=60, check=True).stdout
        torch.cuda.synchronize()
    return float(out.strip().splitlines()[0])


def anchor_rows(rng, B: int, A: int):
    """(qpos, rpos, n) int32 anchor rows shaped like
    tests/test_chain_jax.py:random_anchor_rows: 5..A anchors a row, 2-3
    exon chains plus 20% noise anchors, sorted by (rpos, qpos)."""
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


def align_pass(aligner, seqset, dev, **kw) -> dict:
    """One `aligner.align_seqset_packed(seqset, **kw)` + `emit_sam` pass,
    on the host clock to a synchronise of `dev`.

    The aligner's stats, the launch counts and (on a card) the peak-memory
    counter are reset first; every kernel launch of the pass is bracketed
    by a CUDA event pair (ops/_build.py `timing`).  Returns a dict: `rb`,
    `sam`, `wall_s`, `emit_s` (the SAM text's part of it), `launches` and
    `kernel_ms` (per kernel: launches and summed event milliseconds; no
    launches on the CPU), `stats` (the aligner's) and `peak_device_mb`
    (None on the CPU)."""
    import torch

    from ..ops import _build
    cuda = dev.type == "cuda"
    aligner.stats = aligner.fresh_stats()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    with _build.timing() as kernel_ms:
        t0 = time.perf_counter()
        rb = aligner.align_seqset_packed(seqset, **kw)
        t_emit = time.perf_counter()
        sam = rb.emit_sam(aligner.refs)
        emit = time.perf_counter() - t_emit
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return {"rb": rb, "sam": sam, "wall_s": wall, "emit_s": emit,
            "launches": dict(_build.LAUNCHES), "kernel_ms": kernel_ms,
            "stats": dict(aligner.stats),
            "peak_device_mb": (torch.cuda.max_memory_allocated(dev) / 2**20
                               if cuda else None)}


def first_diff(a: bytes, b: bytes) -> str:
    """The first differing SAM record of two SAM texts, for a message."""
    la, lb = a.split(b"\n"), b.split(b"\n")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return (f"record {i}:\n  port: {x[:300]!r}\n"
                    f"  host: {y[:300]!r}")
    return f"line counts differ: port {len(la)} vs host {len(lb)}"
