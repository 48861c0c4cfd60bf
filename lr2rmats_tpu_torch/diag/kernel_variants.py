"""Time variants of the hand kernels side by side on the card.

Each variant is one CUDA source built alone into its own library:
`csrc/chain.cu`, `csrc/shift_dp.cu`, `csrc/junction.cu` and
`csrc/hamming.cu` of this package, and any other sources that export the
same C entry points (for example from a `git archive` of an earlier
commit).  The junction kernel is also timed against an earlier pair of
sources that did its work in three launches (`--split`): `shift_dp.cu` on
each flank, then `combine.cu` (`lr2_combine`).  Every variant runs on the same seeded
inputs at chip_smoke.py's main-path shapes, must equal the plain PyTorch
version bit for bit, and is timed by both of `diag/measure.py`'s timers
(20 calls after a warm-up: back to back as the host issues them, and
queued behind a spin kernel), in turns: first in order, then in reverse.

    python -m lr2rmats_tpu_torch.diag.kernel_variants
        [--chain OTHER/chain.cu ...] [--shift OTHER/shift_dp.cu ...]
        [--junction OTHER/junction.cu ...]
        [--split OTHER/shift_dp.cu OTHER/combine.cu]
        [--hamming OTHER/hamming.cu ...]

Prints one line per variant and shape, the card's name and power limit
(nvidia-smi), then one JSON line with the mean of the two turns for each
timer; exits 1 when a variant disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..align.chain import ChainParams
from ..ops import _build
from ..ops.chain import (chain_dp_backtrack_reference, chain_dp_reference,
                         chain_params_for_kernel)
from ..junctions.sjcount_device import hamming_reference
from ..ops.junction import (B_DEF, junction_place_reference,
                            prepare_junction_batch)
from ..ops.splice import shift_dp_reference
from .measure import anchor_rows, cuda_ms, queued_ms

CHAIN_SHAPES = ((128, 1664), (64, 320))                 # (A, B)
SHIFT_SHAPES = ((8, 192, 512, np.int8), (4, 64, 3485, np.int32))
JUNCTION_G, MIN_INTRON = 3485, 20
HAMMING_C, HAMMING_L, HAMMING_N = 131072, 150, 20_000_000
REPS = 20
MIN_SCORE = 20.0
# the C entry point of an earlier combine.cu (the junction kernel's second
# half before it was fused with the flank DPs)
COMBINE_SIGNATURE = [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [
    ctypes.c_void_p] * 7


def build_variant(src: str) -> ctypes.CDLL:
    """`src` alone, compiled as a library under build/ and bound."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"variant_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        # per thread: two variants with the same bytes build side by side
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                              "-shared", "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
        for line in res.stderr.splitlines():     # -Xptxas -v: registers, spills
            if "registers" in line or "spill" in line:
                print(f"{src}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(so)
    _build.bind(lib, [n for n in _build.SIGNATURES if hasattr(lib, n)])
    if hasattr(lib, "lr2_combine"):
        lib.lr2_combine.restype = ctypes.c_int
        lib.lr2_combine.argtypes = COMBINE_SIGNATURE
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


def junction_inputs(rng, G):
    """A prepare_junction_batch batch of G gaps on a random genome, as
    chip_smoke.py's random gaps: m < 64, 15% query mutations, a quarter of
    spans too short for an intron, anchor-prior centres 0-6."""
    ref = rng.integers(0, 4, 400_000).astype(np.uint8)
    gaps = []
    for _ in range(G):
        m = int(rng.integers(0, 64))
        lr = int(rng.integers(100, len(ref) - 20_000))
        short = rng.random() < 0.25
        span = int(rng.integers(m + 4, m + 20) if short else
                   rng.integers(m + 40, m + 5000))
        q = ref[lr: lr + m].copy()
        mut = rng.random(m) < 0.15
        q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        gaps.append((q, lr, lr + span, int(rng.integers(0, 7)),
                     int(rng.integers(0, 7))))
    b = prepare_junction_batch(ref, gaps, B_DEF)
    return [b[k] for k in ("q", "qr", "lwin", "rwin", "m", "span", "dok",
                           "aok", "el", "er")]


def junction_case(lib, inputs, parent=None):
    """(launch fn, check fn) of the junction kernel of `lib`, or, with
    `parent` = (shift_dp lib, combine lib), of the three launches it
    replaces."""
    q, qr, lwin, rwin, m, span, dok, aok, el, er = inputs
    M, G = q.shape
    dev = q.device
    W = 2 * B_DEF + 1
    score = torch.empty(G, dtype=torch.float32, device=dev)
    bj, bcl, bcr, vote = (torch.empty(G, dtype=torch.int32, device=dev)
                          for _ in range(4))
    found = torch.empty(G, dtype=torch.bool, device=dev)
    outs = [t.data_ptr() for t in (score, bj, bcl, bcr, vote, found)]
    S = [torch.empty((M + 1, W, G), dtype=torch.float32, device=dev)
         for _ in range(2)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        if parent is None:
            rc = lib.lr2_junction(*(t.data_ptr() for t in inputs), M, G,
                                  B_DEF, MIN_INTRON, *outs, stream)
        else:
            rc = 0
            for S_, qq, ww in zip(S, (q, qr), (lwin, rwin)):
                rc = rc or parent[0].lr2_shift_dp(
                    qq.data_ptr(), ww.data_ptr(), m.data_ptr(),
                    S_.data_ptr(), M, G, B_DEF, 4, stream)
            rc = rc or parent[1].lr2_combine(
                S[0].data_ptr(), S[1].data_ptr(),
                *(t.data_ptr() for t in (m, span, dok, aok, el, er)), M, G,
                B_DEF, MIN_INTRON, *outs, stream)
        if rc != 0:
            raise RuntimeError(f"junction variant refused its launch: {rc}")

    def exact():
        run()
        want = junction_place_reference(*inputs, B_DEF, MIN_INTRON)
        return all(torch.equal(a, b) for a, b in zip(
            (score, bj, bcl, bcr, vote, found), want))
    return run, exact


def hamming_inputs(rng):
    """HAMMING_C candidates of HAMMING_L-base reads against a random
    HAMMING_N-base buffer, as chip_smoke.py's: 1% read mutations, half the
    windows elsewhere, 1% past the buffer end."""
    n = HAMMING_N
    buf = rng.integers(0, 4, n).astype(np.uint8)
    S = 4096
    starts = rng.integers(0, n - HAMMING_L, S)
    comb = buf[starts[:, None] + np.arange(HAMMING_L)].copy()
    mut = rng.random(comb.shape) < 0.01
    comb[mut] = (comb[mut] + 1) % 4
    off = np.arange(S + 1, dtype=np.int64) * HAMMING_L
    rid = rng.integers(0, S, HAMMING_C).astype(np.int32)
    pos = starts[rid] + rng.integers(-2, 3, HAMMING_C)
    far = rng.random(HAMMING_C) < 0.5
    pos[far] = rng.integers(0, n, int(far.sum()))
    past = rng.random(HAMMING_C) < 0.01
    pos[past] = n - rng.integers(1, HAMMING_L, int(past.sum()))
    return [buf, comb.reshape(-1), off, rid, pos.astype(np.int64)]


def hamming_case(lib, inputs):
    buf, comb, off, rid, pos = inputs
    C = rid.shape[0]
    mm = torch.empty(C, dtype=torch.int32, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream

    def run():
        rc = lib.lr2_hamming(buf.data_ptr(), buf.shape[0], comb.data_ptr(),
                             off.data_ptr(), rid.data_ptr(), pos.data_ptr(),
                             C, mm.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"hamming variant refused its launch: {rc}")

    def exact():
        run()
        return torch.equal(mm, hamming_reference(*inputs))
    return run, exact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chain", nargs="*", default=[],
                    help="other chain.cu sources to time beside")
    ap.add_argument("--shift", nargs="*", default=[],
                    help="other shift_dp.cu sources to time beside")
    ap.add_argument("--junction", nargs="*", default=[],
                    help="other junction.cu sources to time beside")
    ap.add_argument("--split", nargs=2, default=None,
                    metavar=("SHIFT_DP_CU", "COMBINE_CU"),
                    help="an earlier shift_dp.cu and combine.cu, timed as "
                    "the three launches junction.cu replaces")
    ap.add_argument("--hamming", nargs="*", default=[],
                    help="other hamming.cu sources to time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    csrc = os.path.dirname(_build.SOURCES[0])
    parent = list(args.split or [])
    builds = ([("chain.cu", os.path.join(csrc, "chain.cu"))]
              + [(src, src) for src in args.chain]
              + [("shift_dp.cu", os.path.join(csrc, "shift_dp.cu"))]
              + [(src, src) for src in args.shift]
              + [("junction.cu", os.path.join(csrc, "junction.cu"))]
              + [(src, src) for src in args.junction]
              + [(src, src) for src in parent]
              + [("hamming.cu", os.path.join(csrc, "hamming.cu"))]
              + [(src, src) for src in args.hamming])
    with ThreadPoolExecutor(len(builds)) as pool:       # one nvcc each
        libs = list(pool.map(lambda b: build_variant(b[1]), builds))
    named = dict(zip((b[1] for b in builds), libs))
    parent_libs = tuple(named[src] for src in parent)
    chain_vars = [(b[0], lib) for b, lib in zip(builds, libs)
                  if hasattr(lib, "lr2_chain_dp_backtrack")]
    shift_vars = [(b[0], lib) for b, lib in zip(builds, libs)
                  if hasattr(lib, "lr2_shift_dp") and b[1] not in parent]
    junction_vars = [(b[0], lib) for b, lib in zip(builds, libs)
                     if hasattr(lib, "lr2_junction")]
    hamming_vars = [(b[0], lib) for b, lib in zip(builds, libs)
                    if hasattr(lib, "lr2_hamming")]

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
    inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in junction_inputs(rng, JUNCTION_G)]
    shape = f"junction G={JUNCTION_G}"
    for name, lib in junction_vars:
        cases.append((name, shape, *junction_case(lib, inputs)))
    if parent_libs:
        cases.append((f"{parent[0]} x2 + {parent[1]}", shape,
                      *junction_case(None, inputs, parent_libs)))
    inputs = [torch.from_numpy(a).to(dev) for a in hamming_inputs(rng)]
    for name, lib in hamming_vars:
        cases.append((name, f"hamming C={HAMMING_C} L={HAMMING_L}",
                      *hamming_case(lib, inputs)))

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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(json.dumps({"card": card.strip().splitlines()[0], **{
        key: {f"{name} {shape}": sum(ts) / len(ts)
              for (k, name, shape), ts in times.items() if k == key}
        for key in timers}}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
