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
log2f; the log probe calls the logf that torch.log calls; the shift-DP scores are integers; the combine scores are integers or
multiples of 3/8, evaluated in the plain version's order; the Hamming
counts and seed ranges are integers.

The tests named *_cards / *_every_card need two or more cards and run in
one call on a four-card machine (README, "One process, several cards").

`junction_gaps` and `sim_dataset` are shared with the CPU tests
(tests/test_torch_junction.py, tests/test_torch_pipeline.py).
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
from lr2rmats_tpu_torch.align.polish import polish_best_pair
from lr2rmats_tpu_torch.ops import _build
from lr2rmats_tpu_torch.ops.chain import (chain_dp, chain_dp_backtrack,
                                          chain_dp_backtrack_reference,
                                          chain_dp_reference,
                                          chain_params_for_kernel)
from lr2rmats_tpu_torch.ops.splice import shift_dp, shift_dp_reference

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


def junction_gaps(seed, n, kind="random", ref_len=100_000):
    """(ref, gaps) of (q, left_ref, right_ref, el, er) junction gaps.

    random: the tests/test_splice_device.py recipe (m < 64, half with a
    planted GT..AG, 15% query mutations) plus anchor-prior centres and a
    quarter of spans too short for any intron (not-found lanes);
    ties: homopolymer query and windows, so many cells tie;
    m0: empty gap queries."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    if kind == "ties":
        ref[:] = 0
        ref[rng.random(ref_len) < 0.01] = 2
    gaps = []
    for _ in range(n):
        m = 0 if kind == "m0" else int(rng.integers(0, 64))
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
    parameters in turn; every launch reads the table of its own."""
    import threading
    q, g, n = (torch.from_numpy(a).to(dev) for a in _anchor_rows(9, 512, 128))
    params = (chain_params_for_kernel(ChainParams()), _other_params())
    want = [chain_dp_backtrack_reference(q, g, n, kp, 20.0) for kp in params]
    results = [[], []]

    def work(t):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for k in range(12):
                kp = params[(t + k) % 2]
                results[t].append(((t + k) % 2,
                                   chain_dp_backtrack(q, g, n, kp, 20.0)))
            torch.cuda.synchronize()

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not torch.equal(want[0][0], want[1][0])
    for res in results:
        assert len(res) == 12
        for which, got in res:
            assert all(torch.equal(a, b) for a, b in zip(got, want[which]))


@pytest.mark.parametrize("A,B", [(128, 256), (512, 64), (1024, 64),
                                 (4096, 16), (8, 37)])
def test_chain_dp_kernel_matches_plain(dev, A, B):
    """csrc/chain_dp.cu == the plain DP at any width, and == the fused
    kernel's f / parent where that takes the rows (A <= 512)."""
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
    band, M, G = 8, 192, 256
    q, lwin, m = _windows(1, band, M, G, np.int8)
    qr, rwin, _ = _windows(2, band, M, G, np.int8)
    rng = np.random.default_rng(3)
    dl = rng.integers(-2, M + band + 2, G).astype(np.int32)
    dr = rng.integers(-2, M + band + 2, G).astype(np.int32)
    arrs = [torch.from_numpy(a) for a in (q, qr, lwin, rwin, m, dl, dr)]
    want = polish_best_pair(*arrs)
    got = polish_best_pair(*[a.to(dev) for a in arrs]).cpu()
    assert torch.equal(got, want)


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
    assert got == ref.align_seqset_packed(seqset).emit_sam(ref.refs)


def _bench_slice(n_reads=512):
    """A 2 Mb bench.py workload (the port's generator, seed 123)."""
    from lr2rmats_tpu_torch import synth
    rng = np.random.default_rng(123)
    g = synth.build_genome(2_000_000, rng)
    reads, _ = synth.simulate_reads(g, n_reads, rng, profile="ont")
    return g, synth.pack_seqset(reads,
                                [f"read{i}" for i in range(len(reads))])


def test_pallas_backend_slice_on_card_matches_host_backend(dev):
    """backend="pallas": every row through csrc/chain_dp.cu, host
    backtrack; the SAM of the host backend."""
    from lr2rmats_tpu_torch.align.batch import BatchAligner, TorchBatchAligner
    g, seqset = _bench_slice()
    ref = BatchAligner(g)
    port = TorchBatchAligner(g, index=ref.index, device="cuda",
                             backend="pallas")
    port.warmup_chain_shapes()
    before = dict(_build.LAUNCHES)
    got = port.align_seqset_packed(seqset).emit_sam(port.refs)
    assert _build.LAUNCHES["chain_dp"] > before["chain_dp"]
    assert _build.LAUNCHES["chain_dp_backtrack"] == \
        before["chain_dp_backtrack"]
    assert got == ref.align_seqset_packed(seqset).emit_sam(ref.refs)


@pytest.mark.parametrize("backend", ["torch", "pallas"])
def test_slice_split_over_every_card(dev, backend):
    """TorchBatchAligner(devices=every card): each chain launch split in
    one row block per card; SAM identical to one card, and every card
    launched kernels."""
    from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two cards")
    g, seqset = _bench_slice()
    one = TorchBatchAligner(g, device="cuda:0", backend=backend)
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    every = TorchBatchAligner(g, index=one.index, device="cuda:0",
                              backend=backend, devices=cards)
    every.warmup_chain_shapes()
    want = one.align_seqset_packed(seqset).emit_sam(one.refs)
    _build.reset_launches()
    got = every.align_seqset_packed(seqset).emit_sam(every.refs)
    assert sorted(_build.CARD_LAUNCHES) == list(range(n_cards))
    assert all(v > 0 for v in _build.CARD_LAUNCHES.values())
    assert got == want


def _junction_tensors(ref, gaps, dev):
    from lr2rmats_tpu_torch.ops.junction import prepare_junction_batch
    b = prepare_junction_batch(ref, gaps)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in b.items() if k != "B"}
    SL = shift_dp(t["q"], t["lwin"], t["m"], 4)
    SR = shift_dp(t["qr"], t["rwin"], t["m"], 4)
    return (SL, SR, t["m"], t["span"], t["dok"], t["aok"], t["el"], t["er"],
            4)


@pytest.mark.parametrize("kind,G", [("random", 2048), ("ties", 300),
                                    ("m0", 40), ("random", 5)])
def test_combine_kernel_matches_plain(dev, kind, G):
    from lr2rmats_tpu_torch.ops.junction import combine, combine_reference
    args = _junction_tensors(*junction_gaps(G, G, kind), dev)
    before = _build.LAUNCHES["combine"]
    got = combine(*args, 30)
    assert _build.LAUNCHES["combine"] == before + 1
    want = combine_reference(*args, 30)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if kind == "random":
        assert bool(want[5].any()) and not bool(want[5].all())


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
    for k in ("chain_dp_backtrack", "shift_dp", "combine", "hamming"):
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
