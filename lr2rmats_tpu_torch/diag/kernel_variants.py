"""Time variants of the hand kernels side by side on the card.

Each variant is one CUDA source built alone into its own library:
`csrc/chain.cu` (its fused kernel and its DP-only kernel),
`csrc/shift_dp.cu`, `csrc/junction.cu`, `csrc/hamming.cu` and
`csrc/log_probe.cu` of this package, and any other sources that export the
same C entry points (for example from a `git archive` of an earlier
commit; an earlier `chain_dp.cu` exports `lr2_chain_dp`).  Every variant
runs on the same seeded inputs at chip_smoke.py's shapes (the DP-only
chain kernel on random rows at its dp shapes and windows), must equal the
plain PyTorch version bit for bit, and is timed by both of
`diag/measure.py`'s timers (20 calls after a warm-up: back to back as the
host issues them, and queued behind a spin kernel), in turns: first in
order, then in reverse.

    python -m lr2rmats_tpu_torch.diag.kernel_variants
        [--chain OTHER/chain.cu ...] [--chain-dp OTHER/chain_dp.cu ...]
        [--shift OTHER/shift_dp.cu ...] [--junction OTHER/junction.cu ...]
        [--hamming OTHER/hamming.cu ...] [--log-probe OTHER/log_probe.cu ...]

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
from .chain_parity import log_probe_reference, probe_sample
from ..junctions.sjcount_device import hamming_reference
from ..ops.junction import (B_DEF, junction_place_reference,
                            prepare_junction_batch)
from ..ops.splice import shift_dp_reference
from .measure import anchor_rows, card_line, cuda_ms, queued_ms

CHAIN_SHAPES = ((128, 1664), (64, 320))                 # (A, B)
# chip_smoke.py's dp shapes: its first-batch and mesh-row widths (random
# rows here), its random rows, and its windows past the main path's 64
DP_SHAPES = ((128, 1664, 64), (512, 1536, 64), (1024, 256, 64),
             (4096, 32, 64), (1024, 256, 256), (2048, 64, 1024))
LOG_PROBE_NS = (37376, 1 << 22)          # the diagnostic's [292, 128]; 16 MB
SHIFT_SHAPES = ((8, 192, 512, np.int8), (4, 64, 3485, np.int32))
JUNCTION_G, MIN_INTRON = 3485, 20
HAMMING_C, HAMMING_L, HAMMING_N = 131072, 150, 20_000_000
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


def chain_dp_case(lib, inputs, kp, want):
    """(launch fn, check fn) of one DP-only chain variant on one shape;
    want: the plain version's (f, parent)."""
    q, g, n = inputs
    B, A = q.shape
    f = torch.empty((B, A), dtype=torch.float32, device=q.device)
    par = torch.empty((B, A), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def run():
        rc = lib.lr2_chain_dp(
            q.data_ptr(), g.data_ptr(), n.data_ptr(), B, A, kp.window, kp.k,
            kp.max_qgap, kp.max_intron, kp.min_intron_gap, kp.gap_open,
            kp.gap_scale, kp.intron_scale, f.data_ptr(), par.data_ptr(),
            stream)
        if rc != 0:
            raise RuntimeError(f"chain_dp variant refused its launch: {rc}")

    def exact():
        run()
        return torch.equal(f, want[0]) and torch.equal(par, want[1])
    return run, exact


def log_probe_case(lib, x):
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        rc = lib.lr2_log_probe(x.data_ptr(), y.data_ptr(), x.numel(), stream)
        if rc != 0:
            raise RuntimeError(f"log_probe variant refused its launch: {rc}")

    def exact():
        run()
        return torch.equal(y, log_probe_reference(x))
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


def junction_case(lib, inputs):
    """(launch fn, check fn) of the junction kernel of `lib`."""
    q, qr, lwin, rwin, m, span, dok, aok, el, er = inputs
    M, G = q.shape
    dev = q.device
    score = torch.empty(G, dtype=torch.float32, device=dev)
    bj, bcl, bcr, vote = (torch.empty(G, dtype=torch.int32, device=dev)
                          for _ in range(4))
    found = torch.empty(G, dtype=torch.bool, device=dev)
    outs = [t.data_ptr() for t in (score, bj, bcl, bcr, vote, found)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        rc = lib.lr2_junction(*(t.data_ptr() for t in inputs), M, G, B_DEF,
                              MIN_INTRON, *outs, stream)
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


# (flag, entry point, this package's source, what the variants replace)
KINDS = (("chain", "lr2_chain_dp_backtrack", "chain.cu",
          "other chain.cu sources (the fused kernel) to time beside"),
         ("chain_dp", "lr2_chain_dp", "chain.cu",
          "other sources of lr2_chain_dp (the DP alone) to time beside"),
         ("shift", "lr2_shift_dp", "shift_dp.cu",
          "other shift_dp.cu sources to time beside"),
         ("junction", "lr2_junction", "junction.cu",
          "other junction.cu sources to time beside"),
         ("hamming", "lr2_hamming", "hamming.cu",
          "other hamming.cu sources to time beside"),
         ("log_probe", "lr2_log_probe", "log_probe.cu",
          "other log_probe.cu sources to time beside"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for kind, _, _, what in KINDS:
        ap.add_argument("--" + kind.replace("_", "-"), dest=kind, nargs="*",
                        default=[], metavar="SOURCE", help=what)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    csrc = os.path.dirname(_build.SOURCES[0])
    # (label, source) of each kind's variants, this package's first
    variants = {kind: [(own, os.path.join(csrc, own))]
                + [(src, src) for src in getattr(args, kind)]
                for kind, _, own, _ in KINDS}
    sources = sorted({src for vs in variants.values() for _, src in vs})
    with ThreadPoolExecutor(len(sources)) as pool:      # one nvcc each
        libs = dict(zip(sources, pool.map(build_variant, sources)))
    for kind, entry, _, _ in KINDS:
        for label, src in variants[kind]:
            if not hasattr(libs[src], entry):
                raise SystemExit(f"{src} does not export {entry}")

    def of(kind):
        return [(label, libs[src]) for label, src in variants[kind]]

    kp = chain_params_for_kernel(ChainParams())
    rng = np.random.default_rng(123)
    cases: List[Tuple[str, str, object, object]] = []
    for A, B in CHAIN_SHAPES:
        inputs = [torch.from_numpy(a).to(dev) for a in anchor_rows(rng, B, A)]
        for name, lib in of("chain"):
            cases.append((name, f"A={A} B={B}", *chain_case(lib, inputs, kp)))
    for A, B, window in DP_SHAPES:
        kw = chain_params_for_kernel(ChainParams(window=window))
        inputs = [torch.from_numpy(a).to(dev) for a in anchor_rows(rng, B, A)]
        want = chain_dp_reference(*inputs, kw)
        for name, lib in of("chain_dp"):
            cases.append((name, f"dp A={A} B={B} window={window}",
                          *chain_dp_case(lib, inputs, kw, want)))
    for band, M, G, dt in SHIFT_SHAPES:
        inputs = [torch.from_numpy(a).to(dev)
                  for a in code_windows(rng, band, M, G, dt)]
        for name, lib in of("shift"):
            cases.append((name, f"band={band} M={M} G={G}",
                          *shift_case(lib, inputs, band)))
    inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in junction_inputs(rng, JUNCTION_G)]
    for name, lib in of("junction"):
        cases.append((name, f"junction G={JUNCTION_G}",
                      *junction_case(lib, inputs)))
    inputs = [torch.from_numpy(a).to(dev) for a in hamming_inputs(rng)]
    for name, lib in of("hamming"):
        cases.append((name, f"hamming C={HAMMING_C} L={HAMMING_L}",
                      *hamming_case(lib, inputs)))
    probe = torch.from_numpy(probe_sample()[1]).to(dev).reshape(-1)
    wide = torch.from_numpy(rng.uniform(1.0, 2e5, LOG_PROBE_NS[1] + 1)
                            .astype(np.float32)).to(dev)
    for label, x in ((f"n={LOG_PROBE_NS[0]}", probe),
                     (f"n={LOG_PROBE_NS[0] - 1} x[1:]", probe[1:]),
                     (f"n={LOG_PROBE_NS[1]}", wide[:-1])):
        for name, lib in of("log_probe"):
            cases.append((name, f"log_probe {label}",
                          *log_probe_case(lib, x)))

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
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"card": card, **{
        key: {f"{name} {shape}": sum(ts) / len(ts)
              for (k, name, shape), ts in times.items() if k == key}
        for key in timers}}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
