"""Time variants of the chain and shift-DP kernels side by side on the card.

Each variant is one CUDA source built alone into its own library:
`csrc/chain.cu` and `csrc/shift_dp.cu` of this package, and any other
sources that export the same C entry points (for example `chain.cu` /
`shift_dp.cu` from a `git archive` of an earlier commit).  Every variant
runs on the same seeded inputs at chip_smoke.py's main-path shapes, must
equal the plain PyTorch version bit for bit, and is timed by both of
`diag/measure.py`'s timers (20 launches after a warm-up: back to back as
the host issues them, and queued behind a spin kernel), in turns: first in
order, then in reverse.

    python -m lr2rmats_tpu_torch.diag.kernel_variants
        [--chain OTHER/chain.cu ...] [--shift OTHER/shift_dp.cu ...]

Prints one line per variant and shape, then one JSON line with the mean of
the two turns for each timer; exits 1 when a variant disagrees with the
plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..align.chain import ChainParams
from ..ops import _build
from ..ops.chain import (chain_dp_backtrack_reference, chain_dp_reference,
                         chain_params_for_kernel)
from ..ops.splice import shift_dp_reference
from .measure import anchor_rows, cuda_ms, queued_ms

CHAIN_SHAPES = ((128, 1664), (64, 320))                 # (A, B)
SHIFT_SHAPES = ((8, 192, 512, np.int8), (4, 64, 3485, np.int32))
REPS = 20
MIN_SCORE = 20.0


def build_variant(src: str) -> ctypes.CDLL:
    """`src` alone, compiled as a library under build/ and bound."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"variant_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                              "-shared", "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _build.bind(lib, [n for n in _build.SIGNATURES if hasattr(lib, n)])
    return lib


def code_windows(rng, band, M, G, dtype):
    """Gap query / window codes over a random genome, m uniform in 0..M,
    8% query mutations, PAD (-9) past m."""
    ref = rng.integers(0, 4, 200_000).astype(dtype)
    q = np.full((M, G), -9, dtype)
    win = np.full((M + band, G), -9, dtype)
    m = rng.integers(0, M + 1, G).astype(np.int32)
    for g in range(G):
        mg, L0 = int(m[g]), int(rng.integers(0, len(ref) - M - band))
        qw = ref[L0: L0 + mg].copy()
        mut = rng.random(mg) < 0.08
        qw[mut] = (qw[mut] + 1) % 4
        q[:mg, g] = qw
        win[:mg + band, g] = ref[L0: L0 + mg + band]
    return q, win, m


def chain_case(lib, inputs, kp):
    """(launch fn, check fn) of one chain variant on one shape."""
    q, g, n = inputs
    B, A = q.shape
    dev = q.device
    mask = torch.empty((B, A), dtype=torch.uint8, device=dev)
    ps = torch.empty(B, dtype=torch.float32, device=dev)
    ss = torch.empty(B, dtype=torch.float32, device=dev)
    f = torch.empty((B, A), dtype=torch.float32, device=dev)
    par = torch.empty((B, A), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(dp_out=False):
        rc = lib.lr2_chain_dp_backtrack(
            q.data_ptr(), g.data_ptr(), n.data_ptr(), B, A, kp.window, kp.k,
            kp.max_qgap, kp.max_intron, kp.min_intron_gap, kp.gap_open,
            kp.gap_scale, kp.intron_scale, MIN_SCORE, mask.data_ptr(),
            ps.data_ptr(), ss.data_ptr(),
            f.data_ptr() if dp_out else None,
            par.data_ptr() if dp_out else None, stream)
        if rc != 0:
            raise RuntimeError(f"chain variant refused its launch: {rc}")

    def exact():
        run(dp_out=True)
        rf, rpar = chain_dp_reference(q, g, n, kp)
        rmask, rps, rss = chain_dp_backtrack_reference(q, g, n, kp,
                                                       MIN_SCORE)
        return (torch.equal(f, rf) and torch.equal(par, rpar)
                and torch.equal(mask, rmask) and torch.equal(ps, rps)
                and torch.equal(ss, rss))
    return run, exact


def shift_case(lib, inputs, band):
    q, win, m = inputs
    M, G = q.shape
    S = torch.empty((M + 1, 2 * band + 1, G), dtype=torch.float32,
                    device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def run():
        rc = lib.lr2_shift_dp(q.data_ptr(), win.data_ptr(), m.data_ptr(),
                              S.data_ptr(), M, G, band, q.element_size(),
                              stream)
        if rc != 0:
            raise RuntimeError(f"shift_dp variant refused its launch: {rc}")

    def exact():
        run()
        return torch.equal(S, shift_dp_reference(q, win, m, band))
    return run, exact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chain", nargs="*", default=[],
                    help="other chain.cu sources to time beside")
    ap.add_argument("--shift", nargs="*", default=[],
                    help="other shift_dp.cu sources to time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    csrc = os.path.dirname(_build.SOURCES[0])
    builds = ([("chain.cu", os.path.join(csrc, "chain.cu"))]
              + [(src, src) for src in args.chain]
              + [("shift_dp.cu", os.path.join(csrc, "shift_dp.cu"))]
              + [(src, src) for src in args.shift])
    with ThreadPoolExecutor(len(builds)) as pool:       # one nvcc each
        libs = list(pool.map(lambda b: build_variant(b[1]), builds))
    chain_vars = [(b[0], lib) for b, lib in zip(builds, libs)
                  if hasattr(lib, "lr2_chain_dp_backtrack")]
    shift_vars = [(b[0], lib) for b, lib in zip(builds, libs)
                  if hasattr(lib, "lr2_shift_dp")]

    kp = chain_params_for_kernel(ChainParams())
    rng = np.random.default_rng(123)
    cases: List[Tuple[str, str, object, object]] = []
    for A, B in CHAIN_SHAPES:
        inputs = [torch.from_numpy(a).to(dev) for a in anchor_rows(rng, B, A)]
        for name, lib in chain_vars:
            cases.append((name, f"A={A} B={B}", *chain_case(lib, inputs, kp)))
    for band, M, G, dt in SHIFT_SHAPES:
        inputs = [torch.from_numpy(a).to(dev)
                  for a in code_windows(rng, band, M, G, dt)]
        for name, lib in shift_vars:
            cases.append((name, f"band={band} M={M} G={G}",
                          *shift_case(lib, inputs, band)))

    bad = 0
    timers = {"ms": cuda_ms, "queued_ms": queued_ms}
    times: Dict[Tuple[str, str, str], List[float]] = {}
    for name, shape, run, exact in cases:
        ok = exact()
        bad += not ok
        print(f"{name} {shape}: exact={ok}", flush=True)
    for turn in (cases, cases[::-1]):
        for name, shape, run, _ in turn:
            for key, timer in timers.items():
                times.setdefault((key, name, shape), []).append(
                    timer(run, REPS))
    for (key, name, shape), ts in times.items():
        print(f"{name} {shape} {key}: {ts[0]:.4f} / {ts[1]:.4f}",
              flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), **{
        key: {f"{name} {shape}": sum(ts) / len(ts)
              for (k, name, shape), ts in times.items() if k == key}
        for key in timers}}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
