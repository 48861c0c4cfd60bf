"""Port polish (lr2rmats_tpu_torch/align/polish.py) against the JAX
reference align/polish.py: the fused best-split score, the batched forced
placement and the whole polish pass, on the cases of tests/test_polish.py.
Scores are integer-valued, so everything is exact."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2rmats_tpu.align import polish as jpolish
from lr2rmats_tpu.align.records import RecordBatch
from lr2rmats_tpu_torch.align import polish as tpolish
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
    """polish_best_pair == reference _polish_best_pair on packed lanes."""
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
    got = tpolish.polish_best_pair(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > jpolish.NEG / 2).sum() > G // 4


def test_constrained_place_many_matches_jax():
    ref, items = _place_items()
    want = jpolish._constrained_place_many(items, ref)
    got = tpolish.constrained_place_many(items, ref, "cpu")
    assert got == want
    assert sum(1 for g in got if g and g[0] == "defer") > 0


def test_constrained_place_many_matches_scalar():
    """Every deferred score equals the host scalar DP's."""
    ref, items = _place_items(seed=78, n=120)
    got = tpolish.constrained_place_many(items, ref, "cpu")
    for it, g in zip(items, got):
        want = jpolish._constrained_place(*it[:1], ref, *it[1:])
        assert (want is None) == (g is None)
        if want is not None:
            assert (g[1] if g[0] == "defer" else g[0]) == want[0]


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


def test_polish_batch_matches_jax_many_reads():
    """Many reads over a few genes with misplaced junctions: both the
    batched singles and the sequential multi-junction path."""
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
    offs = np.array([0, len(codes)], np.int64)
    ja, tb = _rb_pair(recs)
    jc, tc = [], []
    n_j = jpolish.polish_batch(ja, codes, offs, changed_out=jc)
    n_t = tpolish.polish_batch(tb, codes, offs, "cpu", changed_out=tc)
    assert n_t == n_j > 0
    assert tc == jc
    _assert_same_batch(tb, ja)
