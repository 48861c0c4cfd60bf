"""Card timers and the random anchor rows that chip_smoke.py and
`diag/kernel_variants.py` share.

Two timers, both over CUDA events around `reps` calls after a warm-up call:
`cuda_ms` times the calls back to back as the host issues them, so a
kernel shorter than a call's Python is timed at the host's launch rate;
`queued_ms` first queues a spin kernel (~5 ms) so that the calls' kernels
wait behind it and run back to back, and times the kernels alone.
"""

from __future__ import annotations

import numpy as np

SPIN_CYCLES = 10_000_000  # the spin kernel of queued_ms, ~5 ms on an H100


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
