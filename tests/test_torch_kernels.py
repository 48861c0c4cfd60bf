"""Hand-written CUDA kernels against their plain PyTorch versions on the
card (marker `cuda`; each test skips where torch.cuda.is_available() is
false).  This file imports neither jax nor the reference package, so it
also runs on a machine without them; the card's outputs are held to the
port's own host backend and CPU runs (the CPU tests link those to the
reference):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Every comparison is exact: the chain kernels round each float32 add and
multiply like the plain version's elementwise ops and call the same
log2f; the log probe calls the logf that torch.log calls; the shift-DP
scores are integers; the junction kernel's scores are integers or
multiples of 3/8, exact in float32 in the plain version's order and in
its own; the Hamming counts and seed ranges are integers.

The tests named *_cards / *_every_card need two or more cards and run in
one call on a four-card machine (README, "One process, several cards").

`junction_gaps`, `junction_edge_batch` and `sim_dataset` are shared
with the CPU tests (tests/test_torch_junction.py,
tests/test_torch_pipeline.py).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lr2rmats_tpu_torch.align.chain import ChainParams
from lr2rmats_tpu_torch.align.polish import place_lanes
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.ops.chain import (chain_dp, chain_dp_backtrack,
                                          chain_dp_backtrack_reference,
                                          chain_dp_reference,
                                          chain_params_for_kernel)
from lr2rmats_tpu_torch.ops.splice import (polish_trace,
                                           polish_trace_reference, shift_dp,
                                           shift_dp_reference, trace_width)

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


def junction_gaps(seed, n, kind="random", ref_len=100_000, m=None):
    """(ref, gaps) of (q, left_ref, right_ref, el, er) junction gaps.

    random: the tests/test_splice_device.py recipe (m < 64, half with a
    planted GT..AG, 15% query mutations) plus anchor-prior centres and a
    quarter of spans too short for any intron (not-found lanes);
    ties: homopolymer query and windows, so many cells tie;
    m0: empty gap queries.  m: the same query length for every gap."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    if kind == "ties":
        ref[:] = 0
        ref[rng.random(ref_len) < 0.01] = 2
    gaps = []
    m_fixed = m
    for _ in range(n):
        m = 0 if kind == "m0" else (
            m_fixed if m_fixed is not None else int(rng.integers(0, 64)))
        lr = int(rng.integers(100, ref_len - 20000))
        short = kind == "random" and rng.random() < 0.25
        span = int(rng.integers(m + 4, m + 20) if short else
                   rng.integers(m + 40, m + 5000))
        q = ref[lr: lr + m].copy()
        if kind == "random":
            mut = rng.random(m) < 0.15
            q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if kind != "ties" and rng.random() < 0.5:
            j = int(rng.integers(0, m + 1))
            ref[lr + j], ref[lr + j + 1] = 2, 3
            last = lr + span - (m - j) - 1
            ref[last - 1], ref[last] = 0, 2
        gaps.append((q, lr, lr + span, int(rng.integers(0, 7)),
                     int(rng.integers(0, 7))))
    return ref, gaps


JUNCTION_EDGES = ("m1", "m64", "neg_flanks", "no_class", "intron_edge",
                  "ties_lanes", "wide_prior", "m_outside")


def junction_edge_batch(kind, G, seed=0, min_intron=30):
    """`prepare_junction_batch`'s arrays (q, qr, lwin, rwin, m, span, dok,
    aok, el, er) for G gaps of one edge kind of the junction DP:
    m1 / m64: every query 1 or MGAP = 64 bases (M = m);
    neg_flanks: empty queries whose spans let only cl + cr <= 3 through
    the intron gate, so every open cell sums NEG flank cells (-2e18)
    while the gated ones are NEG;
    no_class: no donor (even gaps) or no acceptor (odd gaps) class
    anywhere, so every cell is gated;
    intron_edge: spans put the gate's threshold on cl + cr at -2..18;
    ties_lanes: homopolymer gaps with a GT / AG class at every offset, so
    equal maxima lie in many lanes;
    wide_prior: anchor-prior centres 0, 7, 2^19, 2^19 + 1, 10^7 and
    -2^30 (past 2^19 the kernel keeps the plain order of the sum);
    m_outside: m from -3 to 80 against M = 64 (past every batch the
    aligner packs; the plain version clips)."""
    from lr2rmats_tpu_torch.ops.junction import (MGAP,
                                                 prepare_junction_batch)
    rng = np.random.default_rng(seed + 100)
    m = {"m1": 1, "m64": MGAP, "neg_flanks": 0}.get(kind)
    ref, gaps = junction_gaps(seed, G, "ties" if kind == "ties_lanes"
                              else "random", m=m)
    b = prepare_junction_batch(ref, gaps)
    B = b["B"]
    if kind == "neg_flanks":
        b["span"] = (min_intron + b["m"] - 2 * B
                     + rng.integers(0, 4, G)).astype(np.int64)
    elif kind == "no_class":
        b["dok"][:, ::2] = -1
        b["aok"][:, 1::2] = -1
    elif kind == "intron_edge":
        b["span"] = (min_intron + b["m"] - 2 * B
                     + rng.integers(-2, 19, G)).astype(np.int64)
    elif kind == "ties_lanes":
        b["dok"][b["dok"] >= 0] = 1
        b["aok"][b["aok"] >= 0] = 1
    elif kind == "wide_prior":
        wide = np.array([0, 7, 1 << 19, (1 << 19) + 1, 10 ** 7, -(1 << 30)])
        b["el"] = rng.choice(wide, G).astype(np.int32)
        b["er"] = rng.choice(wide, G).astype(np.int32)
    elif kind == "m_outside":
        b["m"] = rng.integers(-3, 81, G).astype(np.int32)
    return [np.ascontiguousarray(b[k]) for k in
            ("q", "qr", "lwin", "rwin", "m", "span", "dok", "aok", "el",
             "er")]


def sim_dataset(out, long_reads=300, short_pairs=1200, genes=10,
                genome_mb=0.5):
    """The scripts/simulate.py dataset at a small size (seed 7), made by
    the port's generator (lr2rmats_tpu_torch/synth.py, the same bytes);
    returns out."""
    from lr2rmats_tpu_torch.synth import simulate_dataset
    simulate_dataset(str(out), genome_mb=genome_mb, genes=genes,
                     long_reads=long_reads, short_pairs=short_pairs)
    return out


def pipeline_config(data, out):
    from lr2rmats_tpu_torch.pipeline.config import (PipelineConfig,
                                                    SampleReads)
    cfg = PipelineConfig(genome_fasta=f"{data}/genome.fa",
                         gtf=f"{data}/anno.gtf")
    cfg.samples["samp1"] = SampleReads(f"{data}/long.fa",
                                       f"{data}/short_1.fa",
                                       f"{data}/short_2.fa")
    cfg.out_dir = str(out)
    return cfg


def pipeline_outputs(out):
    """Bytes of every file the pipeline outputs: output/* and the SAM, BED
    and junction table of alignment/."""
    out = pathlib.Path(out)
    files = sorted((out / "output").iterdir()) + [
        out / "alignment" / f"samp1.{n}" for n in
        ("minimap.sam", "minimap.bed", "STARSJ.out.tab")]
    return {str(f.relative_to(out)): f.read_bytes() for f in files}


SWITCHES = ("LR2RMATS_DEVICE_JUNCTIONS", "LR2RMATS_DEVICE_SEED",
            "LR2RMATS_DEVICE_SJCOUNT")


def host_pipeline(cfg):
    """The port's host pipeline: `run --cpu` with the three device switches
    off (the yardstick of the card runs here)."""
    from lr2rmats_tpu_torch.pipeline.stages import run_pipeline
    saved = {v: os.environ.pop(v) for v in SWITCHES if v in os.environ}
    try:
        return run_pipeline(cfg, device="cpu")
    finally:
        os.environ.update(saved)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _anchor_rows(seed, B, A):
    """2-3 exon chains plus 20% noise per row, sorted by (rpos, qpos)."""
    rng = np.random.default_rng(seed)
    qp = np.zeros((B, A), np.int32)
    rp = np.zeros((B, A), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(0, A + 1))
        q = np.sort(rng.integers(0, 2000, n))
        r = q + 10_000
        for ia in rng.integers(0, 2000, 2):
            r = np.where(q > ia, r + int(rng.integers(50, 40_000)), r)
        r = np.where(rng.random(n) < 0.2, rng.integers(0, 60_000, n), r)
        order = np.lexsort((q, r))
        qp[b, :n], rp[b, :n], ns[b] = q[order], r[order], n
    return qp, rp, ns


def _windows(seed, band, M, G, dtype):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 50_000).astype(dtype)
    q = np.full((M, G), -9, dtype)
    win = np.full((M + band, G), -9, dtype)
    m = np.zeros(G, np.int32)
    for g in range(G):
        mg = int(rng.integers(0, M + 1))
        L0 = int(rng.integers(0, 40_000))
        qw = ref[L0: L0 + mg].copy()
        qw[rng.random(mg) < 0.1] = 2
        q[:mg, g] = qw
        win[:mg + band, g] = ref[L0: L0 + mg + band]
        m[g] = mg
    return q, win, m


@pytest.mark.parametrize("A,B", [(128, 1664), (64, 320), (8, 37)])
def test_chain_kernel_matches_plain(dev, A, B):
    kp = chain_params_for_kernel(ChainParams())
    q, g, n = (torch.from_numpy(a).to(dev) for a in _anchor_rows(A + B, B, A))
    before = _build.LAUNCHES["chain_dp_backtrack"]
    mask, ps, ss, f, parent = chain_dp_backtrack(q, g, n, kp, 20.0,
                                                 dp_out=True)
    assert _build.LAUNCHES["chain_dp_backtrack"] == before + 1
    rf, rparent = chain_dp_reference(q, g, n, kp)
    rmask, rps, rss = chain_dp_backtrack_reference(q, g, n, kp, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(parent, rparent)
    assert torch.equal(f, rf)
    assert torch.equal(mask, rmask)
    assert torch.equal(ps, rps) and torch.equal(ss, rss)
    assert bool((ps > 0).any())


def _edge_chain_rows(kind):
    """(qpos, rpos, n, window) of adversarial chain rows, sorted by
    (rpos, qpos):
      n_edges: n = 0, 1, W and W+1 (W = 64), and full rows;
      ties: each anchor of a colinear chain four times over, so every
        anchor sees runs of equal predecessors and the first must win;
      none_valid: one reference position, so no predecessor is valid;
      odd: A = 37 and B = 5, neither a multiple of the reads a block or a
        warp takes;
      window_65 / window_256 / window_512: windows past the main path's
        64, up to the kernel's widest ring (512 slots);
      window_2000: a window past every row's width (A = 300), which the
        kernel takes as A."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    window = {"window_65": 65, "window_256": 256, "window_512": 512,
              "window_2000": 2000}.get(kind, 64)
    if kind in ("n_edges", "ties", "none_valid"):
        A, B = 128, 41
    elif kind == "odd":
        A, B = 37, 5
    else:
        A, B = (512, 9) if kind == "window_512" else (300, 17)
    if kind == "ties":
        qp = np.zeros((B, A), np.int32)
        rp = np.zeros((B, A), np.int32)
        ns = np.full(B, A, np.int32)
        for b in range(B):
            step = int(rng.integers(12, 40))
            a = np.arange(A) // 4
            qp[b] = 100 + step * a
            rp[b] = 5000 + step * a + (a // 9) * int(rng.integers(0, 60))
        return qp, rp, ns, window
    qp, rp, ns = _anchor_rows(len(kind) * 7 + A, B, A)
    if kind == "n_edges":
        ns[:] = np.resize([0, 1, 64, 65, A], B)
    elif kind == "none_valid":
        rp[:] = 7000
        qp[:] = np.sort(rng.integers(0, 3000, (B, A)), 1)
        ns[:] = A
    elif kind.startswith("window"):
        qp, rp, ns = _anchor_rows(window + B, B, A)
        ns[: B // 2] = A
        for b in range(B // 2):      # dense colinear rows: every slot valid
            qp[b] = np.arange(A) * 3
            rp[b] = 10_000 + np.arange(A) * 3 + rng.integers(0, 2, A).cumsum()
    return qp, rp, ns, window


@pytest.mark.parametrize("kind", ["n_edges", "ties", "none_valid", "odd",
                                  "window_65", "window_256", "window_512",
                                  "window_2000"])
def test_chain_kernel_edge_rows(dev, kind):
    """csrc/chain.cu == the plain version bit for bit on adversarial rows
    (f, parent, mask, ps, ss)."""
    qp, rp, ns, window = _edge_chain_rows(kind)
    kp = chain_params_for_kernel(ChainParams(window=window))
    q, g, n = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in (qp, rp, ns))
    mask, ps, ss, f, parent = chain_dp_backtrack(q, g, n, kp, 20.0,
                                                 dp_out=True)
    rf, rparent = chain_dp_reference(q, g, n, kp)
    rmask, rps, rss = chain_dp_backtrack_reference(q, g, n, kp, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(parent, rparent) and torch.equal(f, rf)
    assert torch.equal(mask, rmask)
    assert torch.equal(ps, rps) and torch.equal(ss, rss)
    if kind == "none_valid":
        assert bool((parent == -1).all()) and bool((ps == 0).all())
    elif kind == "ties":
        # a parent is the first of its four equal copies
        assert bool((parent[parent >= 0] % 4 == 0).all())
    else:
        assert bool((parent >= 0).any())


def _long_intron_rows(seed, B, A):
    """Rows whose exon chains jump 100 kb - 900 kb on the reference, so the
    valid pairs differ between a 200 kb and a 1 Mb intron cap."""
    rng = np.random.default_rng(seed)
    qp = np.zeros((B, A), np.int32)
    rp = np.zeros((B, A), np.int32)
    ns = np.full(B, A, np.int32)
    for b in range(B):
        q = np.sort(rng.integers(0, 2000, A))
        r = q + 10_000
        for ia in rng.integers(0, 2000, 2):
            r = np.where(q > ia, r + int(rng.integers(100_000, 900_000)), r)
        r = np.where(rng.random(A) < 0.2, rng.integers(0, 2_000_000, A), r)
        order = np.lexsort((q, r))
        qp[b], rp[b] = q[order], r[order]
    return qp, rp, ns


def _chain_exact(q, g, n, kp):
    """The kernel's (mask, ps, ss, f, parent) == the plain version's."""
    got = chain_dp_backtrack(q, g, n, kp, 20.0, dp_out=True)
    want = (*chain_dp_backtrack_reference(q, g, n, kp, 20.0),
            *chain_dp_reference(q, g, n, kp))
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(got, want))


def test_chain_kernel_long_introns(dev):
    """STAR's 1 Mb intron cap: the dd range exceeds the cost table, so the
    kernel computes each cost inline; equal to the plain version, and it
    finds chains that the 200 kb default cap refuses."""
    q, g, n = (torch.from_numpy(a).to(dev) for a in _long_intron_rows(3, 64,
                                                                         128))
    star = chain_params_for_kernel(ChainParams(max_intron=1_000_000))
    assert _chain_exact(q, g, n, star)
    ps_star = chain_dp_backtrack(q, g, n, star, 20.0)[1]
    ps_default = chain_dp_backtrack(
        q, g, n, chain_params_for_kernel(ChainParams()), 20.0)[1]
    assert bool((ps_star > ps_default).any())


def _other_params():
    return chain_params_for_kernel(ChainParams(
        gap_scale=0.25, intron_scale=2.0, min_intron_gap=12, max_qgap=300))


def test_chain_kernel_refills_the_cost_table(dev):
    """A change of the chain parameters between launches refills the cost
    table, and a change back refills it again: each launch equals the
    plain version of its own parameters."""
    q, g, n = (torch.from_numpy(a).to(dev) for a in _anchor_rows(7, 256, 128))
    default = chain_params_for_kernel(ChainParams())
    other = _other_params()
    masks = []
    for kp in (default, other, default, other):
        assert _chain_exact(q, g, n, kp)
        masks.append(chain_dp_backtrack(q, g, n, kp, 20.0)[0])
    assert not torch.equal(masks[0], masks[1])


def test_chain_kernel_cost_table_under_threads(dev):
    """Two host threads, each on its own stream, launch with different
    parameters in turn, interleaving the fused kernel and the DP alone,
    which share one cost table; every launch reads the table of its
    own parameters."""
    import threading
    q, g, n = (torch.from_numpy(a).to(dev) for a in _anchor_rows(9, 512, 128))
    params = (chain_params_for_kernel(ChainParams()), _other_params())
    want = [(chain_dp_backtrack_reference(q, g, n, kp, 20.0),
             chain_dp_reference(q, g, n, kp)) for kp in params]
    results = [[], []]

    def work(t):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for k in range(16):
                which = (t + k) % 2
                fused = (k // 2) % 2 == t
                got = (chain_dp_backtrack(q, g, n, params[which], 20.0)
                       if fused else chain_dp(q, g, n, params[which]))
                results[t].append((which, int(not fused), got))
            torch.cuda.synchronize()

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not torch.equal(want[0][0][0], want[1][0][0])
    assert not torch.equal(want[0][1][0], want[1][1][0])
    for res in results:
        assert len(res) == 16
        assert {(w, k) for w, k, _ in res} == {(0, 0), (0, 1), (1, 0),
                                               (1, 1)}
        for which, kernel, got in res:
            assert all(torch.equal(a, b)
                       for a, b in zip(got, want[which][kernel]))


@pytest.mark.parametrize("A,B", [(128, 256), (512, 64), (1024, 64),
                                 (4096, 16), (8, 37)])
def test_chain_dp_kernel_matches_plain(dev, A, B):
    """csrc/chain.cu's DP-only kernel == the plain DP at any width, and ==
    the fused kernel's f / parent where that takes the rows (A <= 512)."""
    kp = chain_params_for_kernel(ChainParams())
    q, g, n = (torch.from_numpy(a).to(dev) for a in _anchor_rows(A * B, B, A))
    before = _build.LAUNCHES["chain_dp"]
    f, parent = chain_dp(q, g, n, kp)
    assert _build.LAUNCHES["chain_dp"] == before + 1
    rf, rparent = chain_dp_reference(q, g, n, kp)
    torch.cuda.synchronize()
    assert torch.equal(parent, rparent) and torch.equal(f, rf)
    assert bool((parent >= 0).any())
    if A <= 512:
        _, _, _, ff, fparent = chain_dp_backtrack(q, g, n, kp, 20.0,
                                                  dp_out=True)
        assert torch.equal(f, ff) and torch.equal(parent, fparent)


def _chain_dp_exact(q, g, n, kp, fused=True):
    """chain_dp == the plain DP bit for bit (one launch), and == the fused
    kernel's f / parent where A <= 512 and `fused`; returns (f, parent)."""
    before = _build.LAUNCHES["chain_dp"]
    f, parent = chain_dp(q, g, n, kp)
    assert _build.LAUNCHES["chain_dp"] == before + 1
    rf, rparent = chain_dp_reference(q, g, n, kp)
    torch.cuda.synchronize()
    assert torch.equal(parent, rparent) and torch.equal(f, rf)
    if fused and q.shape[1] <= 512:
        _, _, _, ff, fparent = chain_dp_backtrack(q, g, n, kp, 20.0,
                                                  dp_out=True)
        assert torch.equal(f, ff) and torch.equal(parent, fparent)
    return f, parent


@pytest.mark.parametrize("window", [1, 31, 32, 33, 64, 65, 256, 257, 512,
                                    513, 1000, 1024])
def test_chain_dp_kernel_windows(dev, window):
    """The DP-only kernel at windows that cross each of its ring sizes (64,
    256, 512, 1024 slots), on rows wider than the window: half dense
    colinear rows, where every slot of the window is valid, half random;
    == the fused kernel where the rows fit it (A = 512)."""
    rng = np.random.default_rng(window)
    for A, B in ((max(2 * window, 96) + 7, 12), (512, 8)):
        if A > 2100:
            continue
        qp, rp, ns = _anchor_rows(window + A, B, A)
        for b in range(B // 2):
            qp[b] = np.arange(A) * 3
            rp[b] = 10_000 + np.arange(A) * 3 + rng.integers(0, 2, A).cumsum()
            ns[b] = A
        kp = chain_params_for_kernel(ChainParams(window=window))
        f, parent = _chain_dp_exact(
            *(torch.from_numpy(a).to(dev) for a in (qp, rp, ns)), kp)
        par = parent[: B // 2].long().cpu()
        back = torch.arange(A)[None, :] - par
        assert bool((par >= 0).any())
        assert bool((back[par >= 0] <= window).all())


@pytest.mark.parametrize("kind", ["n_edges", "window_over_A", "ties",
                                  "long_introns"])
def test_chain_dp_kernel_edge_rows(dev, kind):
    """The DP-only kernel on edge rows, == the plain DP and the fused
    kernel: n = 0, 1, 31, 32, 33 and A (the chunk edges of its streamed
    anchors and stored results); a window over A (taken as A); each anchor
    four times over, so equal scores test first-index ties; STAR's 1 Mb
    intron cap, whose dd range exceeds the cost table (the inline cost)."""
    window = 64
    if kind == "n_edges":
        A, B = 200, 36
        qp, rp, ns = _anchor_rows(11, B, A)
        ns[:] = np.resize([0, 1, 31, 32, 33, A], B)
        for b in range(B):          # full-length rows at every n
            qp[b] = np.arange(A) * 5
            rp[b] = 9_000 + np.arange(A) * 5 + (np.arange(A) // 40) * 700
    elif kind == "window_over_A":
        A, B, window = 300, 17, 1000
        qp, rp, ns = _anchor_rows(12, B, A)
    elif kind == "ties":
        A, B = 400, 9
        qp = np.zeros((B, A), np.int32)
        rp = np.zeros((B, A), np.int32)
        ns = np.full(B, A, np.int32)
        rng = np.random.default_rng(13)
        for b in range(B):
            step = int(rng.integers(12, 40))
            a = np.arange(A) // 4
            qp[b] = 100 + step * a
            rp[b] = 5000 + step * a + (a // 9) * int(rng.integers(0, 60))
    else:
        A, B = 700, 32
        qp, rp, ns = _long_intron_rows(14, B, A)
    params = ChainParams(window=window) if kind != "long_introns" else \
        ChainParams(max_intron=1_000_000)
    kp = chain_params_for_kernel(params)
    q, g, n = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in (qp, rp, ns))
    f, parent = _chain_dp_exact(q, g, n, kp)
    pad = torch.arange(A, device=dev)[None, :] >= n[:, None]
    assert bool((f[pad] == -1e18).all()) and bool((parent[pad] == -1).all())
    if kind == "ties":
        assert bool((parent[parent >= 0] % 4 == 0).all())
    elif kind == "long_introns":
        default = chain_params_for_kernel(ChainParams())
        assert bool((chain_dp(q, g, n, kp)[0].max(1).values
                     > chain_dp(q, g, n, default)[0].max(1).values).any())
    if kind != "ties":
        assert bool((parent >= 0).any())


def test_log_probe_kernel_matches_plain(dev):
    """csrc/log_probe.cu == torch.log(x) * LOG2E, bit for bit, over the
    diagnostic's sample."""
    from lr2rmats_tpu_torch.diag.chain_parity import (log_probe,
                                                      log_probe_reference,
                                                      probe_sample)
    x = torch.from_numpy(probe_sample()[1]).to(dev)
    before = _build.LAUNCHES["log_probe"]
    got = log_probe(x)
    assert _build.LAUNCHES["log_probe"] == before + 1
    assert torch.equal(got, log_probe_reference(x))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 37376, 2 ** 20 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_log_probe_kernel_lengths_and_alignment(dev, n, offset):
    """The log probe's 16-byte path and its scalar tail (n mod 4), and a
    view 4 bytes off 16-byte alignment (x[1:]), == the plain version."""
    from lr2rmats_tpu_torch.diag.chain_parity import (log_probe,
                                                      log_probe_reference)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(0.5, 3e5, n + offset)
                         .astype(np.float32)).to(dev)[offset:]
    assert x.numel() == n and (x.data_ptr() % 16 == 0) == (offset == 0)
    got = log_probe(x)
    assert torch.equal(got, log_probe_reference(x))


def test_chain_dp_refuses_a_window_it_cannot_hold(dev):
    kp = chain_params_for_kernel(ChainParams(window=4096))
    q = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    n = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        chain_dp(q, q, n, kp)


@pytest.mark.parametrize("band,M,G,dtype", [(8, 192, 256, np.int8),
                                            (8, 192, 512, np.int8),
                                            (4, 64, 128, np.int32),
                                            (4, 10, 7, np.int32)])
def test_shift_dp_kernel_matches_plain(dev, band, M, G, dtype):
    q, win, m = (torch.from_numpy(a).to(dev)
                 for a in _windows(M + G, band, M, G, dtype))
    before = _build.LAUNCHES["shift_dp"]
    got = shift_dp(q, win, m, band)
    assert _build.LAUNCHES["shift_dp"] == before + 1
    want = shift_dp_reference(q, win, m, band)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _edge_windows(kind, band, M, G, dtype):
    """Shift-DP gaps: m0 (empty queries), mM (m = M), mismatch (no query
    code equals a window code), pad (PAD codes, 7, inside the queries and
    past every window)."""
    rng = np.random.default_rng(band * 10 + len(kind))
    q = rng.integers(0, 4, (M, G)).astype(dtype)
    win = rng.integers(0, 4, (M + band, G)).astype(dtype)
    m = rng.integers(0, M + 1, G).astype(np.int32)
    if kind == "m0":
        m[:] = 0
    elif kind == "mM":
        m[:] = M
    elif kind == "mismatch":
        q[:] = 0
        win[:] = rng.integers(1, 4, win.shape)
    elif kind == "pad":
        q[rng.random(q.shape) < 0.2] = 7
        for g in range(G):
            q[m[g]:, g] = 7
            win[m[g] + band:, g] = 7
    return q, win, m


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("band,M,G", [(4, 64, 37), (8, 192, 33)])
@pytest.mark.parametrize("kind", ["m0", "mM", "mismatch", "pad"])
def test_shift_dp_kernel_edge_gaps(dev, kind, band, M, G, dtype):
    """csrc/shift_dp.cu == the plain version bit for bit, NEG cells
    included, at G not a multiple of the gaps a block takes."""
    q, win, m = (torch.from_numpy(a).to(dev)
                 for a in _edge_windows(kind, band, M, G, dtype))
    got = shift_dp(q, win, m, band)
    want = shift_dp_reference(q, win, m, band)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((want == -1e18).any()) and bool((want > -1e17).any())


def test_polish_best_pair_card_matches_cpu(dev):
    """The placement's best-split score (place_lanes: both shift DPs and
    polish_trace on the card) == the CPU run's, lane by lane."""
    band, M, G = 8, 192, 256
    q, lwin, m = _windows(1, band, M, G, np.int8)
    qr, rwin, _ = _windows(2, band, M, G, np.int8)
    rng = np.random.default_rng(3)
    dl = rng.integers(-2, M + band + 2, G).astype(np.int32)
    dr = rng.integers(-2, M + band + 2, G).astype(np.int32)
    arrs = [torch.from_numpy(a) for a in (q, qr, lwin, rwin, m, dl, dr)]
    want = place_lanes(*arrs)
    got = place_lanes(*[a.to(dev) for a in arrs]).cpu()
    assert torch.equal(got[:, 0], want[:, 0])
    assert bool((want[:, 1] >= 0).any())


def _placement_lanes(seed, M, G, band=8):
    """Polish lanes as constrained_place_many packs them: a read window of
    m <= M bases over the left flank's DL ref bases and the right flank's
    DR (DL + DR about m), 8% errors and, in every third lane, a 1-3 base
    indel at the junction; every fifth lane outside the band."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 50_000 + 2 * G).astype(np.int8)
    q = np.full((M, G), -9, np.int8)
    qr = np.full((M, G), -9, np.int8)
    lwin = np.full((M + band, G), -9, np.int8)
    rwin = np.full((M + band, G), -9, np.int8)
    m, dl, dr = (np.zeros(G, np.int32) for _ in range(3))
    for g in range(G):
        mg = M if g % 7 == 0 else int(rng.integers(0, M + 1))
        L0 = int(rng.integers(0, 40_000))
        R0 = L0 + mg + band + int(rng.integers(0, 2000))
        DL = int(rng.integers(0, mg + band + 1))
        DR = int(np.clip(mg - DL + rng.integers(-band, band + 1), 0,
                         mg + band))
        if g % 5 == 4:
            DL = (-1, mg + band + 1)[g % 2]
        qw = np.concatenate([ref[L0: L0 + max(DL, 0)],
                             ref[R0 - DR: R0]])
        if g % 3 == 0 and len(qw) > 6:
            at, k = int(rng.integers(1, len(qw) - 4)), int(rng.integers(1, 4))
            qw = (np.concatenate([qw[:at], qw[at + k:]]) if g % 2 else
                  np.concatenate([qw[:at], np.full(k, 2, np.int8), qw[at:]]))
        qw = np.concatenate([qw, ref[:max(mg - len(qw), 0)]])[:mg].copy()
        mut = rng.random(mg) < 0.08
        qw[mut] = (qw[mut] + 1) % 4
        q[:mg, g], qr[:mg, g] = qw, qw[::-1]
        lwin[:mg + band, g] = ref[L0: L0 + mg + band]
        rwin[:mg + band, g] = ref[R0 - mg - band: R0][::-1]
        m[g], dl[g], dr[g] = mg, DL, DR
    return q, qr, lwin, rwin, m, dl, dr


@pytest.mark.parametrize("G", [1280, 37])
def test_polish_trace_kernel_matches_plain(dev, G):
    """csrc/shift_dp.cu's polish_trace == polish_trace_reference bit for bit
    in every word (score, bj, match, nm, both run counts and run lists) at
    the polish shape M = 192, over the card's own S matrices."""
    band, M = 8, 192
    arrs = [torch.from_numpy(a).to(dev) for a in
            _placement_lanes(11 + G, M, G, band)]
    q, qr, lwin, rwin, m, dl, dr = arrs
    SL, SR = shift_dp(q, lwin, m, band), shift_dp(qr, rwin, m, band)
    before = _build.LAUNCHES["polish_trace"]
    got = polish_trace(SL, SR, *arrs).cpu()
    assert _build.LAUNCHES["polish_trace"] == before + 1
    want = polish_trace_reference(*(t.cpu() for t in (SL, SR, *arrs)))
    assert got.shape == (G, trace_width(M))
    assert torch.equal(got, want)
    placed = want[:, 1] >= 0
    assert bool(placed.any()) and bool((~placed).any())
    assert bool((want[placed, 4] > 1).any())          # gaps in the walks
    assert bool((want[:, 4:6] >= 0).all())             # no walk handed back


def test_polish_batch_card_matches_cpu(dev):
    """polish_batch with the placement on the card == the CPU run (the plain
    versions) on many reads: the same CIGARs, NM, AS and changed records,
    with polish_trace launched."""
    from lr2rmats_tpu_torch.align.polish import polish_batch
    from lr2rmats_tpu_torch.align.records import RecordBatch
    from lr2rmats_tpu_torch.io.fasta import decode_seq
    from lr2rmats_tpu_torch.io.sam import OP_M, OP_N, AlnRec
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    recs = []
    for gi in range(300):
        base = 2000 + gi * 6000
        don1, acc1 = base + 100, base + 899
        don2, acc2 = base + 1000, base + 1799
        for d, a in ((don1, acc1), (don2, acc2)):
            codes[d], codes[d + 1] = 2, 3
            codes[a - 1], codes[a] = 0, 2
        read = np.concatenate([codes[base: don1], codes[acc1 + 1: don2],
                               codes[acc2 + 1: acc2 + 101]]).copy()
        for k in range(6):
            seq = read.copy()
            mut = rng.random(len(seq)) < 0.04
            seq[mut] = (seq[mut] + 1) % 4
            s1 = 0 if k < 3 else int(rng.integers(-4, 5))
            s2 = 0 if k < 3 or gi % 2 else int(rng.integers(-4, 5))
            ops = [(OP_M, 100 + s1), (OP_N, 800), (OP_M, 101 - s1 + s2),
                   (OP_N, 800), (OP_M, 100 - s2)]
            recs.append(AlnRec(
                qname=f"g{gi}r{k}", flag=0, tid=0, pos=base, mapq=60,
                cigar=np.array([(l << 4) | op for op, l in ops], np.uint32),
                seq=decode_seq(seq), tags={"NM": 0, "AS": 0}))
    offs = np.array([0, len(codes)], np.int64)
    cpu = RecordBatch.from_alnrecs(recs)
    card = RecordBatch.from_alnrecs(recs)
    c_cpu, c_card = [], []
    before = _build.LAUNCHES["polish_trace"]
    n_cpu = polish_batch(cpu, codes, offs, "cpu", changed_out=c_cpu)
    n_card = polish_batch(card, codes, offs, dev, changed_out=c_card)
    assert _build.LAUNCHES["polish_trace"] > before
    assert n_card == n_cpu > 100
    assert c_card == c_cpu
    for k in ("cig_buf", "cig_offs", "nm", "score"):
        assert np.array_equal(getattr(card, k), getattr(cpu, k)), k


def test_refused_launch_raises(dev):
    """A launch the kernel refuses (A above its shared-memory cap) raises
    instead of returning garbage or silently running the plain version."""
    kp = chain_params_for_kernel(ChainParams())
    q = torch.zeros((4, 1024), dtype=torch.int32, device=dev)
    n = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="failed to launch"):
        chain_dp_backtrack(q, q, n, kp, 20.0)


def test_slice_on_card_matches_host_backend(dev):
    from lr2rmats_tpu_torch.align.batch import BatchAligner, TorchBatchAligner
    g, seqset = _bench_slice()
    ref = BatchAligner(g)
    port = TorchBatchAligner(g, index=ref.index, device="cuda")
    port.warmup_chain_shapes()
    got = port.align_seqset_packed(seqset).emit_sam(port.refs)
    assert port.stats["chain_kernel_launches"] > 0
    assert port.stats["shift_dp_kernel_launches"] > 0
    assert port.stats["polish_trace_kernel_launches"] > 0
    assert got == ref.align_seqset_packed(seqset).emit_sam(ref.refs)


def _bench_slice(n_reads=512):
    """A 2 Mb bench.py workload (the port's generator, seed 123)."""
    from lr2rmats_tpu_torch import synth
    rng = np.random.default_rng(123)
    g = synth.build_genome(2_000_000, rng)
    reads, _ = synth.simulate_reads(g, n_reads, rng, profile="ont")
    return g, synth.pack_seqset(reads,
                                [f"read{i}" for i in range(len(reads))])


def test_slice_split_over_every_card(dev):
    """TorchBatchAligner(devices=every card): each chain launch split in
    one row block per card; SAM identical to one card, and every card
    launched kernels."""
    from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two cards")
    g, seqset = _bench_slice()
    one = TorchBatchAligner(g, device="cuda:0")
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    every = TorchBatchAligner(g, index=one.index, device="cuda:0",
                              devices=cards)
    every.warmup_chain_shapes()
    want = one.align_seqset_packed(seqset).emit_sam(one.refs)
    _build.reset_launches()
    got = every.align_seqset_packed(seqset).emit_sam(every.refs)
    assert sorted(_build.CARD_LAUNCHES) == list(range(n_cards))
    assert all(v > 0 for v in _build.CARD_LAUNCHES.values())
    assert got == want


def _junction_exact(arrays, dev, min_intron=30):
    """csrc/junction.cu == junction_place_reference on all six outputs,
    one launch; returns the plain version's outputs."""
    from lr2rmats_tpu_torch.ops.junction import (junction_place,
                                                 junction_place_reference)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    before = _build.LAUNCHES["junction"]
    got = junction_place(*t, 4, min_intron)
    assert _build.LAUNCHES["junction"] == before + 1
    want = junction_place_reference(*t, 4, min_intron)
    torch.cuda.synchronize()
    for name, g, w in zip(("score", "j", "cl", "cr", "vote", "found"), got,
                          want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    return want


def _batch_arrays(ref, gaps):
    from lr2rmats_tpu_torch.ops.junction import prepare_junction_batch
    b = prepare_junction_batch(ref, gaps)
    return [b[k] for k in ("q", "qr", "lwin", "rwin", "m", "span", "dok",
                           "aok", "el", "er")]


@pytest.mark.parametrize("kind,G", [("random", 2048), ("ties", 300),
                                    ("m0", 40), ("random", 5),
                                    ("random", 1), ("random", 4097)])
def test_combine_kernel_matches_plain(dev, kind, G):
    """The junction kernel (both flank DPs and the combine, which was
    csrc/combine.cu alone) == its plain version, G not a multiple of the
    8 gaps a block takes included."""
    want = _junction_exact(_batch_arrays(*junction_gaps(G, G, kind)), dev)
    if kind == "random" and G > 5:
        assert bool(want[5].any()) and not bool(want[5].all())


@pytest.mark.parametrize("min_intron", [30, 2000])
@pytest.mark.parametrize("kind", JUNCTION_EDGES)
def test_junction_kernel_edge_gaps(dev, kind, min_intron):
    """csrc/junction.cu == the plain version bit for bit on the edges of
    its design: fixed m of 0, 1 and M, NEG flank sums against gated
    cells, no valid class, the intron gate's threshold at every value,
    equal maxima across lanes, the plain-order path of wide prior
    centres, and m outside [0, M]."""
    want = _junction_exact(junction_edge_batch(kind, 37, 5, min_intron),
                           dev, min_intron)
    if kind == "neg_flanks":
        assert not bool(want[5].any())
    if kind == "no_class":
        assert bool((want[0] == -1e18).all())


def _hamming_args(dev, buf, comb, off, rid, pos, shift=0):
    """Tensors on dev; with shift, buf and comb are views that start
    `shift` bytes into their allocations."""
    def put(a):
        return torch.from_numpy(np.r_[np.zeros(shift, a.dtype), a]).to(
            dev)[shift:]
    return [put(buf), put(comb)] + [torch.from_numpy(a).to(dev)
                                    for a in (off, rid, pos)]


def test_hamming_kernel_matches_plain(dev):
    from lr2rmats_tpu_torch.junctions.sjcount_device import (
        hamming, hamming_reference)
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 4, 200_000).astype(np.uint8)
    lens = rng.integers(20, 160, 500)
    comb = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    C = 20_000
    rid = rng.integers(0, len(lens), C).astype(np.int32)
    pos = rng.integers(-50, len(buf) + 50, C).astype(np.int64)
    pos[:100] = len(buf) - 10                     # windows past the end
    args = [torch.from_numpy(a).to(dev) for a in (buf, comb, off, rid, pos)]
    before = _build.LAUNCHES["hamming"]
    got = hamming(*args)
    assert _build.LAUNCHES["hamming"] == before + 1
    want = hamming_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shift", [0, 1, 3])
def test_hamming_kernel_alignments(dev, shift):
    """Word path edges: reads of 0, 1, 7, 149, 150 and 301 bases starting
    at every offset mod 8 of the read buffer, each against windows at
    every offset mod 8 of the buffer, over its start and over its end;
    with shift, both buffers start off a 4-byte boundary."""
    from lr2rmats_tpu_torch.junctions.sjcount_device import (
        hamming, hamming_reference)
    rng = np.random.default_rng(11 + shift)
    n = 20_000
    buf = rng.integers(0, 4, n).astype(np.uint8)
    lens = np.repeat(np.array([0, 1, 7, 149, 150, 301]), 8)
    fill = np.arange(len(lens)) % 8 + 1           # walks the offsets mod 8
    off = np.zeros(2 * len(lens) + 1, np.int64)
    np.cumsum(np.stack([lens, fill], 1).reshape(-1), out=off[1:])
    comb = buf[rng.integers(0, n - off[-1]) + np.arange(off[-1])].copy()
    comb[rng.random(len(comb)) < 0.05] = 3
    pos = []
    rid = []
    for s, L in enumerate(lens):
        base = int(rng.integers(1, (n - 400) // 8)) * 8
        pos += [base + r for r in range(8)]
        pos += [-L - 2, -5, 0, 1, 3, 4, 5]        # over the start
        pos += [n - L - 9, n - L - 8, n - L - 7, n - L, n - L + 3, n - 1,
                n + 2]                            # over the end
        rid += [2 * s] * 22
    args = _hamming_args(dev, buf, comb, off, np.array(rid, np.int32),
                         np.array(pos, np.int64), shift)
    if shift:
        assert args[0].data_ptr() % 4 and args[1].data_ptr() % 4
    got = hamming(*args)
    want = hamming_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((want == 0).any()) and bool((want > 0).any())


def test_hamming_kernel_no_candidates(dev):
    from lr2rmats_tpu_torch.junctions.sjcount_device import hamming
    buf = torch.zeros(64, dtype=torch.uint8, device=dev)
    comb = torch.zeros(8, dtype=torch.uint8, device=dev)
    off = torch.tensor([0, 8], dtype=torch.int64, device=dev)
    before = _build.LAUNCHES["hamming"]
    mm = hamming(buf, comb, off, torch.zeros(0, dtype=torch.int32,
                                             device=dev),
                 torch.zeros(0, dtype=torch.int64, device=dev))
    assert mm.shape == (0,) and mm.dtype == torch.int32
    assert _build.LAUNCHES["hamming"] == before       # nothing to launch


def test_seed_lookup_card_matches_cpu(dev):
    from lr2rmats_tpu_torch.index.minimizer import MinimizerIndex
    from lr2rmats_tpu_torch.io.fasta import Genome
    from lr2rmats_tpu_torch.index.seed_device import TorchSeedLookup
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 500_000).astype(np.uint8)
    idx = MinimizerIndex.build(Genome(["c"], codes,
                                      np.array([0, len(codes)], np.int64)))
    card, cpu = TorchSeedLookup(idx, dev), TorchSeedLookup(idx, "cpu")
    for nq in (0, 1, 4096, 5000):
        q = np.concatenate([rng.choice(idx.hashes, nq // 2),
                            rng.integers(0, 1 << 30, nq - nq // 2).astype(
                                np.uint64)])
        for a, b in zip(card.lookup(q), cpu.lookup(q)):
            np.testing.assert_array_equal(a, b)
    assert card.calls == 3


def test_pipeline_on_card_matches_host_reference(dev, tmp_path, monkeypatch):
    """The port's pipeline with the three device switches on the card gives
    the bytes of its host pipeline (`run --cpu`, switches off)."""
    from lr2rmats_tpu_torch.pipeline.stages import run_pipeline
    data = sim_dataset(tmp_path / "data")
    host_pipeline(pipeline_config(data, tmp_path / "ref"))
    for var in SWITCHES:
        monkeypatch.setenv(var, "1")
    before = dict(_build.LAUNCHES)
    run_pipeline(pipeline_config(data, tmp_path / "port"), device="cuda")
    for k in ("chain_dp_backtrack", "shift_dp", "junction", "hamming"):
        assert _build.LAUNCHES[k] > before[k], k
    assert pipeline_outputs(tmp_path / "port") == \
        pipeline_outputs(tmp_path / "ref")


@pytest.mark.parametrize("H", [4, 8])
def test_mesh_step_on_card_matches_plain(dev, H):
    """sharded_align_step on a world-1 (1, 1) mesh over NCCL: 128
    minimizers x H hits = 512 or 1024 anchors a read (the DP-only kernel
    has no cap), one chain_dp launch, the plain DP's scores exactly."""
    import socket

    import torch.distributed as dist
    from lr2rmats_tpu_torch.parallel.distributed import backend
    from lr2rmats_tpu_torch.parallel.mesh import (make_mesh,
                                                  sharded_align_step)
    rng = np.random.default_rng(13)
    M, B, Q = 8192, 64, 128
    h = np.sort(rng.choice(2 ** 31, M, replace=False)).astype(np.uint32)
    pos = np.sort(rng.integers(0, 10 ** 6, M)).astype(np.int32)
    start = rng.integers(0, M - Q, B)
    rh = h[start[:, None] + np.arange(Q)]
    rq = (pos[start[:, None] + np.arange(Q)] - pos[start][:, None] +
          rng.integers(0, 3, (B, Q))).astype(np.int32)
    rh[:, ::7] = rng.choice(h, (B, len(range(0, Q, 7))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend(), init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, "cuda")
        before = _build.LAUNCHES["chain_dp"]
        got = sharded_align_step(mesh, hits_per_seed=H)(h, pos, rh, rq)
        assert _build.LAUNCHES["chain_dp"] == before + 1
        want = sharded_align_step(mesh, hits_per_seed=H, plain=True)(
            h, pos, rh, rq)
        assert got.device.type == "cuda" and torch.equal(got, want)
        assert float(want.max()) > 100.0
    finally:
        dist.destroy_process_group()


_MESH_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.parallel import distributed as d
from lr2rmats_tpu_torch.parallel.mesh import make_mesh, sharded_align_step
pid, nproc, coord, data, out, dev_type = sys.argv[1:7]
pid, nproc = int(pid), int(nproc)
if dev_type == "cuda":
    torch.cuda.set_device(pid % torch.cuda.device_count())
if nproc > 1:
    d.init_multihost(coord, nproc, pid)
else:
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=1, rank=0)
n = 2 if nproc == 4 else 1
mesh = make_mesh(n, n, dev_type)
z = np.load(data)
args = [z[k] for k in ("h", "pos", "rh", "rq")]
got = sharded_align_step(mesh)(*args)
launches = _build.LAUNCHES["chain_dp"]
want = sharded_align_step(mesh, plain=True)(*args)
np.savez(f"{out}.{pid}.npz", got=got.cpu().numpy(), want=want.cpu().numpy())
with open(f"{out}.{pid}.json", "w") as f:
    json.dump({"launches": launches, "device": str(got.device)}, f)
dist.destroy_process_group()
"""


def _mesh_step_data(path):
    """Anchors that chain: reads take runs of consecutive index entries
    whose positions ascend; every 7th minimizer is a random hit."""
    rng = np.random.default_rng(17)
    M, B, Q = 8192, 64, 64
    h = np.sort(rng.choice(2 ** 31, M, replace=False)).astype(np.uint32)
    pos = np.sort(rng.integers(0, 10 ** 6, M)).astype(np.int32)
    start = rng.integers(0, M - Q, B)
    rh = h[start[:, None] + np.arange(Q)]
    rq = (pos[start[:, None] + np.arange(Q)] - pos[start][:, None] +
          rng.integers(0, 3, (B, Q))).astype(np.int32)
    rh[:, ::7] = rng.choice(h, (B, len(range(0, Q, 7))))
    np.savez(path, h=h, pos=pos, rh=rh, rq=rq)


def test_mesh_step_multi_rank_nccl(dev, tmp_path):
    """sharded_align_step on a (2, 2) mesh of four cards over NCCL (one
    rank per card): every rank's kernel scores equal its plain DP's
    exactly, and the scores of a world-1 CPU (gloo) run at rtol 1e-5."""
    import socket
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL refuses two ranks on one card")
    data = tmp_path / "data.npz"
    _mesh_step_data(data)
    script = tmp_path / "rank.py"
    script.write_text(_MESH_RANK)
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    out = str(tmp_path / "res")
    cpu_out = str(tmp_path / "cpu")
    cmds = [[sys.executable, str(script), str(pid), "4",
             f"127.0.0.1:{ports[0]}", str(data), out, "cuda"]
            for pid in range(4)]
    cmds.append([sys.executable, str(script), "0", "1",
                 f"127.0.0.1:{ports[1]}", str(data), cpu_out, "cpu"])
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(c, cwd=str(REPO), env=env, text=True,
                              stderr=subprocess.PIPE) for c in cmds]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for e in errs]
    ref = np.load(f"{cpu_out}.0.npz")["want"]
    devices = set()
    for pid in range(4):
        z = np.load(f"{out}.{pid}.npz")
        with open(f"{out}.{pid}.json") as f:
            info = json.load(f)
        np.testing.assert_array_equal(z["got"], z["want"])
        np.testing.assert_allclose(z["got"], ref, rtol=1e-5)
        assert info["launches"] == 1
        devices.add(info["device"])
    assert devices == {f"cuda:{i}" for i in range(4)}
    assert ref.max() > 100.0


def test_pipeline_two_processes_two_cards(dev, tmp_path):
    """`python -m lr2rmats_tpu_torch run` as two processes of one group,
    one per card (cuda:{process_id % device_count}), with the three device
    switches: the one-process host pipeline's outputs, byte for byte."""
    import socket
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from lr2rmats_tpu_torch.pipeline.config import PipelineConfig
    data = sim_dataset(tmp_path / "data")
    with open(data / "long.fa") as f:
        lines = f.read().splitlines(keepends=True)
    heads = [i for i, ln in enumerate(lines) if ln.startswith(">")]
    cut = heads[len(heads) // 2]
    for name, part in (("a", lines[:cut]), ("b", lines[cut:])):
        (tmp_path / f"long_{name}.fa").write_text("".join(part))
    shorts = f"{data}/short_1.fa {data}/short_2.fa"
    (tmp_path / "long.list").write_text(
        f"2\n1\n{tmp_path}/long_a.fa\n1\n{tmp_path}/long_b.fa\n")
    (tmp_path / "short.list").write_text(f"2\n1\n{shorts}\n1\n{shorts}\n")
    lists = [f"{data}/genome.fa", f"{data}/anno.gtf",
             str(tmp_path / "long.list"), str(tmp_path / "short.list")]
    cfg = PipelineConfig.from_read_lists(*lists)
    cfg.out_dir = str(tmp_path / "ref")
    host_pipeline(cfg)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "LR2RMATS_DEVICE_JUNCTIONS": "1", "LR2RMATS_DEVICE_SEED": "1",
           "LR2RMATS_DEVICE_SJCOUNT": "1"}
    out = tmp_path / "port"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lr2rmats_tpu_torch", "run", "--genome",
         lists[0], "--gtf", lists[1], "--long-read-list", lists[2],
         "--short-read-list", lists[3], "--out-dir", str(out),
         "--coordinator", coord, "--num-processes", "2", "--process-id",
         str(pid)], cwd=str(REPO), env=env, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for e in errs]
    want = {f.name: f.read_bytes() for f in (tmp_path / "ref" /
                                                  "output").iterdir()}
    got = {f.name: f.read_bytes() for f in (out / "output").iterdir()}
    assert len(want) == 15 and got == want
    for pid in range(2):
        log = (out / "logs" / f"pipeline.p{pid}.log").read_text()
        assert f"process {pid}/2 on cuda:{pid}" in log


def test_pipeline_one_process_every_card(dev, tmp_path, monkeypatch):
    """run_pipeline(devices=every card) in one process splits the chain
    launches over every card: the host pipeline's bytes."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from lr2rmats_tpu_torch.pipeline.stages import run_pipeline
    data = sim_dataset(tmp_path / "data")
    host_pipeline(pipeline_config(data, tmp_path / "ref"))
    for var in SWITCHES:
        monkeypatch.setenv(var, "1")
    n_cards = torch.cuda.device_count()
    _build.reset_launches()
    run_pipeline(pipeline_config(data, tmp_path / "port"), device="cuda",
                 devices=[f"cuda:{i}" for i in range(n_cards)])
    assert sorted(_build.CARD_LAUNCHES) == list(range(n_cards))
    assert pipeline_outputs(tmp_path / "port") == \
        pipeline_outputs(tmp_path / "ref")
    log = (tmp_path / "port" / "logs" / "pipeline.log").read_text()
    assert "split over " + ", ".join(f"cuda:{i}" for i in range(n_cards)) \
        in log


@pytest.mark.parametrize("cap, max_intron", [(None, 200_000), (6000, 200_000),
                                             (None, 1000)])
def test_seed_select_matches_plain(dev, cap, max_intron):
    """The seed_select kernel against its plain version on a GRCh38-shaped
    batch (1536 reads, ~870 queries and ~4400 hits a read): every row
    description and kept anchor; with a budget of 6000 hits the widest
    reads are left to the host path; with max_intron 1000 the chains
    split into many groups."""
    from lr2rmats_tpu_torch.diag import seed_batch
    from lr2rmats_tpu_torch.index.seed_device import (
        SELECT_CAP, seed_select, seed_select_reference)
    cap = SELECT_CAP if cap is None else cap
    b = seed_batch.grch38_like(19)
    args = seed_batch.args(b, dev)
    rh = np.diff(b["hoff"])
    assert 4000 < rh.mean() < 4800 and len(rh) == 1536
    rest = (seed_batch.K, max_intron, 500, 128)
    before = _build.LAUNCHES["seed_select"]
    meta, out = seed_select(*args, *rest, cap=cap,
                            widest=int(rh[rh <= cap].max()))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["seed_select"] == before + 1
    pm, po = seed_select_reference(*args, *rest, cap)
    assert torch.equal(meta, pm)
    n = int(pm[:, 0].clamp(min=0).sum())
    assert n > 100 * int((pm[:, 0] >= 0).sum())
    assert torch.equal(out[:n], po[:n])
    assert bool((pm[:, 0] < 0).any()) == (cap < int(rh.max()))
