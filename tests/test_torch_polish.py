"""Port polish (lr2rmats_tpu_torch/align/polish.py) against the JAX
reference align/polish.py: the best-split score, the split and traceback
of the batched forced placement (ops/splice.py polish_trace's plain
version) against the host DP's full result, the batched forced placement
and the whole polish pass, on the cases of tests/test_polish.py.  Scores
are integer-valued, so everything is exact."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2rmats_tpu.align import polish as jpolish
from lr2rmats_tpu.align.records import RecordBatch
from lr2rmats_tpu_torch.align import polish as tpolish
from lr2rmats_tpu_torch.ops.splice import (polish_trace, shift_dp,
                                           trace_runs, trace_width)
from lr2rmats_tpu_torch.utils.log import counter_totals, reset_spans, tracing
from tests.test_polish import _toy_junction_set
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)


def _place_items(seed=77, n=300, ref_len=200_000):
    """tests/test_polish.py::test_constrained_place_many_matches_scalar."""
    B = jpolish.B
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    items = []
    for _ in range(n):
        m = int(rng.integers(0, 120))
        L0 = int(rng.integers(100, 150_000))
        span = int(rng.integers(max(m - 5, 1) + 60, m + 4000))
        R0 = L0 + span
        qwin = ref[L0: L0 + m].copy()
        mut = rng.random(m) < 0.1
        qwin[mut] = (qwin[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        j = int(rng.integers(0, m + 2 * B + 1)) - B
        don = L0 + max(j, -2)
        ilen = span - m + int(rng.integers(-B, B + 1))
        acc = don + max(ilen, 10) - 1
        items.append((qwin, L0, R0, don, acc))
    items.append((ref[500:560].copy(), 500, 560 + 4, 520, 540))
    return ref, items


def test_best_pair_matches_jax():
    """place_lanes' score == reference _polish_best_pair on packed lanes."""
    B, M, G = jpolish.B, jpolish._PLACE_M, 512
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 100_000).astype(np.int8)
    q = np.full((M, G), -9, np.int8)
    qr = np.full((M, G), -9, np.int8)
    lwin = np.full((M + B, G), -9, np.int8)
    rwin = np.full((M + B, G), -9, np.int8)
    m_arr = np.zeros(G, np.int32)
    dl = np.zeros(G, np.int32)
    dr = np.zeros(G, np.int32)
    for g in range(G - 37):                 # trailing lanes stay padding
        m = int(rng.integers(0, M + 1))
        L0 = int(rng.integers(0, 90_000))
        R0 = L0 + m + B + int(rng.integers(0, 3000))
        qw = ref[L0: L0 + m].copy()
        qw[rng.random(m) < 0.1] = 1
        q[:m, g], qr[:m, g] = qw, qw[::-1]
        lwin[:m + B, g] = ref[L0: L0 + m + B]
        rwin[:m + B, g] = ref[R0 - m - B: R0][::-1]
        m_arr[g] = m
        dl[g] = int(rng.integers(-2, m + B + 2))
        dr[g] = int(rng.integers(-2, m + B + 2))
    arrs = (q, qr, lwin, rwin, m_arr, dl, dr)
    want = np.asarray(jpolish._polish_best_pair(*map(jnp.asarray, arrs)))
    rows = tpolish.place_lanes(*map(torch.from_numpy, arrs)).numpy()
    got = np.ascontiguousarray(rows[:, 0]).view(np.float32)
    np.testing.assert_array_equal(got, want)
    assert (got > jpolish.NEG / 2).sum() > G // 4
    assert ((rows[:, 1] >= 0) == (got > jpolish.NEG / 2)).all()


def test_constrained_place_many_matches_jax():
    """Every task gives the JAX package's `_constrained_place` result in
    full, and every task the reference batch defers carries its score."""
    ref, items = _place_items()
    deferred = jpolish._constrained_place_many(items, ref)
    got = tpolish.constrained_place_many(items, ref, "cpu")
    n_card = 0
    for it, g, d in zip(items, got, deferred):
        want = jpolish._constrained_place(it[0], ref, *it[1:])
        assert g == want
        if d is not None and d[0] == "defer":
            n_card += 1
            assert g[0] == d[1]
        else:
            assert d == want
    assert n_card > 100


def test_constrained_place_many_matches_scalar():
    """Every task gives the host scalar DP's full result."""
    ref, items = _place_items(seed=78, n=120)
    got = tpolish.constrained_place_many(items, ref, "cpu")
    for it, g in zip(items, got):
        want = jpolish._constrained_place(*it[:1], ref, *it[1:])
        assert g == want


def _trace_tasks(seed, G=96):
    """(ref, tasks) of (qwin, L0, R0, don, acc) placement tasks the batch
    carries (m <= 192, span >= m + B), in kinds that stress the split and
    the walk: random windows, indels at the junction, homopolymer windows
    (many splits tie), splits at the band's edges (DL or DR at 0 or at
    m + B), m = 192 and m = 0, and infeasible lanes (DL or DR outside the
    band)."""
    B, M = jpolish.B, jpolish._PLACE_M
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 400_000).astype(np.uint8)
    kinds = ("random", "indel", "ties", "edge", "m192", "m0", "infeasible")
    tasks = []
    for g in range(G):
        kind = kinds[g % len(kinds)]
        m = {"m192": M, "m0": 0}.get(kind, int(rng.integers(1, M + 1)))
        L0 = 1000 + g * 4000
        span = m + B + int(rng.integers(0, 600))
        R0 = L0 + span
        # ref bases the two flanks consume: about m together, so a split
        # fits the band
        DL = int(rng.integers(0, m + B + 1))
        DR = int(np.clip(m - DL + rng.integers(-B, B + 1), 0, m + B))
        if kind == "edge":
            DL, DR = ((0, m + B), (m + B, 0), (0, 0),
                      (m + B, m + B))[(g // len(kinds)) % 4]
        elif kind == "infeasible":
            DL = (-1, m + B + 1)[g % 2]
        don, acc = L0 + DL, R0 - 1 - DR
        if kind == "ties":
            ref[L0: R0] = 1
        # the read's bases: the left flank's DL ref bases and the right
        # flank's DR, cut or padded to m, with errors
        qwin = np.concatenate([ref[L0: L0 + max(DL, 0)],
                               ref[acc + 1: R0]])[:m].copy()
        if len(qwin) < m:
            qwin = np.concatenate([qwin, ref[L0: L0 + m - len(qwin)]])
        if kind == "indel" and m > 4:
            at = int(np.clip(DL + rng.integers(-2, 3), 1, m - 2))
            if g % 2:
                qwin = np.concatenate([qwin[:at], [3, 3], qwin[at:]])[:m]
            else:
                qwin = np.concatenate([qwin[:at], qwin[at + 2:],
                                       ref[R0: R0 + 2]])[:m]
        if kind != "ties":
            mut = rng.random(m) < 0.08
            qwin[mut] = (qwin[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        tasks.append((np.ascontiguousarray(qwin, np.uint8), L0, R0, don,
                      acc))
    return ref, tasks


def _pack(ref, tasks):
    """constrained_place_many's lanes (int8, PAD=-9) for tasks."""
    B, M = jpolish.B, jpolish._PLACE_M
    G = len(tasks)
    q = np.full((M, G), -9, np.int8)
    qr = np.full((M, G), -9, np.int8)
    lwin = np.full((M + B, G), -9, np.int8)
    rwin = np.full((M + B, G), -9, np.int8)
    m_arr, dl, dr = (np.zeros(G, np.int32) for _ in range(3))
    for g, (qwin, L0, R0, don, acc) in enumerate(tasks):
        m = len(qwin)
        q[:m, g], qr[:m, g] = qwin, qwin[::-1]
        lwin[:m + B, g] = ref[L0: L0 + m + B]
        rwin[:m + B, g] = ref[R0 - m - B: R0][::-1]
        m_arr[g], dl[g], dr[g] = m, don - L0, R0 - 1 - acc
    return [torch.from_numpy(a) for a in (q, qr, lwin, rwin, m_arr, dl, dr)]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_polish_trace_reference_matches_host_place(seed):
    """polish_trace's plain version over the shift-DP lanes == the JAX
    package's `_constrained_place` (score, left ops, right ops, match, NM)
    for every task, None included."""
    B, M = jpolish.B, jpolish._PLACE_M
    ref, tasks = _trace_tasks(seed)
    q, qr, lwin, rwin, m, dl, dr = _pack(ref, tasks)
    SL, SR = shift_dp(q, lwin, m, B), shift_dp(qr, rwin, m, B)
    rows = polish_trace(SL, SR, q, qr, lwin, rwin, m, dl, dr).numpy()
    assert rows.shape == (len(tasks), trace_width(M))
    n_none = n_gap = 0
    for row, (qwin, L0, R0, don, acc) in zip(rows, tasks):
        want = jpolish._constrained_place(qwin, ref, L0, R0, don, acc)
        got = tpolish._traced(row, trace_runs(M))
        assert got == want
        if want is None:
            n_none += 1
            assert row[1] == -1 and not row[2:].any()
        else:
            n_gap += any(op != 0 for op, _ in want[1] + want[2])
            nl, nr = int(row[4]), int(row[5])
            assert not row[6 + nl: 6 + trace_runs(M)].any()
            assert not row[6 + trace_runs(M) + nr:].any()
    assert n_none >= len(tasks) // 7 and n_gap > 0


@pytest.mark.parametrize("side", [4, 5])
def test_failed_walk_raises(side):
    """A run count of -1 (a walk with no predecessor, which no finite cell
    gives) is a fault of the kernel: `_traced` raises, and the task is not
    placed on the host in its stead."""
    M = 16
    row = np.zeros(trace_width(M), np.int32)
    row[0] = np.float32(3.0).view(np.int32)
    row[1], row[4], row[5] = 2, 1, 1
    row[6] = row[6 + trace_runs(M)] = 2 << 4
    assert tpolish._traced(row, trace_runs(M))[1:3] == ([(0, 2)], [(0, 2)])
    row[side] = -1
    with pytest.raises(RuntimeError):
        tpolish._traced(row, trace_runs(M))


def test_polish_trace_validates_inputs():
    B, M, G = 8, 16, 4
    q = torch.zeros((M, G), dtype=torch.int8)
    win = torch.zeros((M + B, G), dtype=torch.int8)
    m = torch.full((G,), M, dtype=torch.int32)
    S = shift_dp(q, win, m, B)
    args = [S, S, q, q, win, win, m, m * 0, m * 0]
    assert polish_trace(*args).shape == (G, trace_width(M))
    with pytest.raises(ValueError):
        polish_trace(*args, band=4)
    with pytest.raises(ValueError):
        polish_trace(*args[:4], win[:M], *args[5:])          # not [M+B, G]
    with pytest.raises(TypeError):
        polish_trace(S.double(), *args[1:])
    with pytest.raises(TypeError):
        polish_trace(*args[:2], q.to(torch.int32), *args[3:])
    with pytest.raises(TypeError):
        polish_trace(*args[:6], m.long(), *args[7:])


def _rb_pair(recs):
    rb = RecordBatch.from_alnrecs(recs)
    return rb, copy.deepcopy(rb)


def _assert_same_batch(a: RecordBatch, b: RecordBatch):
    np.testing.assert_array_equal(a.cig_buf, b.cig_buf)
    np.testing.assert_array_equal(a.cig_offs, b.cig_offs)
    np.testing.assert_array_equal(a.nm, b.nm)
    np.testing.assert_array_equal(a.score, b.score)


@pytest.mark.parametrize("subset", ["all", "clean_only"])
def test_polish_batch_matches_jax_toy(subset):
    codes, recs, _ = _toy_junction_set()
    if subset == "clean_only":
        recs = recs[:2]
    offs = np.array([0, len(codes)], np.int64)
    ja, tb = _rb_pair(recs)
    jc, tc = [], []
    n_j = jpolish.polish_batch(ja, codes, offs, changed_out=jc)
    n_t = tpolish.polish_batch(tb, codes, offs, "cpu", changed_out=tc)
    assert n_t == n_j == (1 if subset == "all" else 0)
    assert tc == jc
    _assert_same_batch(tb, ja)


def _many_reads():
    """(codes, records): reads over six genes of two introns each, two of
    every five with junctions shifted off the true splice sites."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 40_000).astype(np.uint8)
    from lr2rmats_tpu.io.fasta import decode_seq
    from lr2rmats_tpu.io.sam import OP_M, OP_N, AlnRec
    recs = []
    for gi in range(6):
        base = 2000 + gi * 6000
        don1, acc1 = base + 100, base + 899
        don2, acc2 = base + 1000, base + 1799
        for d, a in ((don1, acc1), (don2, acc2)):
            codes[d], codes[d + 1] = 2, 3
            codes[a - 1], codes[a] = 0, 2
        read = np.concatenate([codes[base: don1], codes[acc1 + 1: don2],
                               codes[acc2 + 1: acc2 + 101]])
        for k in range(5):
            s1 = 0 if k < 3 else int(rng.integers(-4, 5))
            s2 = 0 if k < 3 or gi % 2 else int(rng.integers(-4, 5))
            l1 = 100 + s1
            ops = [(OP_M, l1), (OP_N, 800), (OP_M, 101 - s1 + s2),
                   (OP_N, 800), (OP_M, 100 - s2)]
            recs.append(AlnRec(
                qname=f"g{gi}r{k}", flag=0, tid=0, pos=base, mapq=60,
                cigar=np.array([(l << 4) | op for op, l in ops], np.uint32),
                seq=decode_seq(read), tags={"NM": 0, "AS": 0}))
    return codes, recs


def test_polish_batch_matches_jax_many_reads():
    """Many reads over a few genes with misplaced junctions: both the
    batched singles and the sequential multi-junction path."""
    codes, recs = _many_reads()
    offs = np.array([0, len(codes)], np.int64)
    ja, tb = _rb_pair(recs)
    jc, tc = [], []
    n_j = jpolish.polish_batch(ja, codes, offs, changed_out=jc)
    n_t = tpolish.polish_batch(tb, codes, offs, "cpu", changed_out=tc)
    assert n_t == n_j > 0
    assert tc == jc
    _assert_same_batch(tb, ja)


def test_host_dp_counts_no_card_task():
    """With a device, `lr2rmats.polish.host_dp` counts the host placements
    alone: the device=None run's count less the device tasks, and the
    result is the same bytes."""
    codes, recs = _many_reads()
    offs = np.array([0, len(codes)], np.int64)
    counts, batches = {}, {}
    for device in (None, "cpu"):
        rb = RecordBatch.from_alnrecs(copy.deepcopy(recs))
        reset_spans()
        with tracing():
            tpolish.polish_batch(rb, codes, offs, device)
        counts[device] = counter_totals()
        batches[device] = rb
    reset_spans()
    on, off = counts["cpu"], counts[None]
    tasks = on["lr2rmats.polish.tasks"]
    assert tasks > 0 and "lr2rmats.polish.tasks" not in off
    assert on["lr2rmats.polish.tried"] == off["lr2rmats.polish.tried"]
    assert on["lr2rmats.polish.host_dp"] == \
        off["lr2rmats.polish.host_dp"] - tasks
    assert on["lr2rmats.polish.host_dp"] <= \
        on["lr2rmats.polish.tried"] - tasks
    _assert_same_batch(batches["cpu"], batches[None])
