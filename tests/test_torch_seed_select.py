"""The hit selection on the device (index/seed_device.py `seed_select`,
plain PyTorch on the CPU) against the host path of align/batch.py
`_batch_anchors`: the same rows in the same order, field by field (read,
strand, q, g, base, n_big, q_max).

  * hand-made indexes and query batches for the edges of the host path:
    hits across chromosome boundaries, gaps at and just over max_intron,
    clusters of equal counts (the rank's tie rule), clusters over A_MAX
    and reads so long that a row keeps more than A_MAX anchors, reads
    with no hits or no queries, positions past 2^31, and reads whose hits
    overflow a small device budget and take the host path alone;
  * the counters: lookup_queries and hits equal the host path's, and
    hits_card the hits of the reads the device selected.

The saturated deployment's cases are in tests/test_torch_seed_select_genome.py.
"""

import numpy as np
import pytest
import torch

from lr2rmats_tpu_torch.align import batch as port_batch
from lr2rmats_tpu_torch.align.aligner import AlignParams
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.align.chain import ChainParams
from lr2rmats_tpu_torch.index import seed_device
from lr2rmats_tpu_torch.index.minimizer import MinimizerIndex
from lr2rmats_tpu_torch.index.seed_device import (META, SELECT_CAP,
                                                  seed_select)
from lr2rmats_tpu_torch.io.fasta import Genome
from lr2rmats_tpu_torch.utils.log import counter_totals, reset_spans, tracing
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

GRCH38_BP = 3_088_269_832
MAX_INTRON = 1000
A_MAX = port_batch.A_BUCKETS[-1]


class Batch:
    """A hand-made index and the query batch `_batch_minimizers` would
    give: each query its own hash, its hits chosen by the case."""

    def __init__(self, chrom_offsets, k=15):
        self.k = k
        self.offsets = np.asarray(chrom_offsets, np.int64)
        self.reads = []          # per read: (length, [(qp, qs, hits)])

    def read(self, length, queries):
        self.reads.append((length, queries))

    def build(self):
        hashes, pos, strand, qh, qp, qs, rid = [], [], [], [], [], [], []
        nxt = 1
        for ri, (_, queries) in enumerate(self.reads):
            for q, s, hits in queries:
                h = nxt
                nxt += 1
                qh.append(h)
                qp.append(q)
                qs.append(s)
                rid.append(ri)
                for g, gs in hits:
                    hashes.append(h)
                    pos.append(g)
                    strand.append(gs)
        order = np.argsort(np.asarray(hashes, np.uint64), kind="stable")
        index = MinimizerIndex(
            self.k, 5, np.asarray(hashes, np.uint64)[order],
            np.asarray(pos, np.int64)[order],
            np.asarray(strand, np.int8)[order], self.offsets,
            [f"c{i}" for i in range(len(self.offsets) - 1)])
        mins = (np.asarray(qh, np.uint64), np.asarray(qp, np.int64),
                np.asarray(qs, np.int8), np.asarray(rid, np.int32),
                [n for n, _ in self.reads])
        return index, mins


def _cluster(rng, g0, q0, n, step_g, step_q, st, qs=None):
    """n anchors of one chain: (qp, qs, [(g, gs)]) with the read's strand
    st, spaced step_g / step_q."""
    out = []
    for i in range(n):
        s = int(rng.integers(0, 2)) if qs is None else qs
        out.append((q0 + i * step_q, s, [(g0 + i * step_g, s ^ st)]))
    return out


def _noise(rng, n, lo, hi):
    return [(int(rng.integers(0, 400)), int(rng.integers(0, 2)),
             [(int(rng.integers(lo, hi)), int(rng.integers(0, 2)))
              for _ in range(int(rng.integers(1, 6)))]) for _ in range(n)]


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "chromosomes":
        b = Batch([0, 10_000, 10_100, 60_000, 200_000])
        # a chain across the 10_000 boundary, one in the 100-base
        # chromosome, one across 60_000, and noise over all four
        b.read(500, _cluster(rng, 9_900, 0, 40, 5, 10, 0) +
               _noise(rng, 30, 0, 200_000))
        b.read(600, _cluster(rng, 10_010, 5, 12, 7, 9, 1) +
               _cluster(rng, 59_950, 200, 30, 4, 11, 0) +
               _noise(rng, 40, 9_000, 61_000))
        for _ in range(6):
            b.read(700, _noise(rng, 80, 9_990, 10_110))
    elif name == "max_intron":
        b = Batch([0, 1_000_000])
        for gap in (MAX_INTRON - 1, MAX_INTRON, MAX_INTRON + 1):
            for st in (0, 1):
                q = _cluster(rng, 5_000, 0, 4, 10, 10, st)
                q += _cluster(rng, 5_030 + gap, 40, 4, 10, 10, st)
                q += _cluster(rng, 5_060 + 2 * gap + 2, 80, 3, 10, 10, st)
                b.read(300, q)
    elif name == "ties":
        b = Batch([0, 10_000_000])
        for _ in range(8):
            q = []
            # six groups of 3 and two of 5 on each strand, 5 kb apart,
            # in shuffled query order: the ranks keep group order on ties
            starts = rng.permutation(8) * 5_000 + 100_000
            for i, g0 in enumerate(starts):
                n = 5 if i < 2 else 3
                for st in (0, 1):
                    q += _cluster(rng, int(g0) + st * 1_000_000, 20 * i, n,
                                  3, 2, st)
            rng.shuffle(q)
            b.read(400, q)
    elif name == "big_clusters":
        b = Batch([0, 50_000_000])
        # 300 anchors within 2 kb of query; steps of 70 kb in the
        # reference every 50 anchors (n_big); and a 3-anchor echo
        for st in (0, 1):
            q = []
            for i in range(300):
                g = 1_000_000 + i * 5 + (i // 50) * 70_000
                s = int(rng.integers(0, 2))
                q.append((i * 6, s, [(g, s ^ st)]))
            q += _cluster(rng, 30_000_000, 10, 3, 20, 20, st)
            b.read(2_000, q)
    elif name == "long_reads":
        b = Batch([0, 400_000_000])
        # 300 kb reads (under 2^19): 2000 anchors over ~300 kb of query
        # keep qspan // 250 + 2 > A_MAX of them
        for st in (0, 1):
            q = _cluster(rng, 10_000_000, 0, 2_000, 150, 149, st)
            q += _noise(rng, 50, 0, 400_000_000)
            b.read(300_000, q)
    elif name == "empty":
        b = Batch([0, 1_000_000])
        b.read(300, [(i * 5, 0, []) for i in range(20)])      # no hits
        b.read(200, _cluster(rng, 500, 0, 10, 10, 10, 0))
        b.read(100, [])                                        # no queries
        b.read(300, [(i * 5, 1, []) for i in range(5)])
        b.read(150, [(3, 0, [(7, 1)])])                        # one hit
    elif name == "past_2_31":
        off = [0, 2**31 - 5_000, 2**31 + 1_000_000, GRCH38_BP]
        b = Batch(off)
        for st in (0, 1):
            b.read(800, _cluster(rng, 2**31 - 5_300, 0, 60, 9, 10, st) +
                   _noise(rng, 60, 2**31 - 10_000, 2**31 + 2_000_000))
            b.read(800, _cluster(rng, GRCH38_BP - 2_000, 30, 50, 30, 12, st)
                   + _noise(rng, 60, 3 * 10**9, GRCH38_BP))
    else:
        raise KeyError(name)
    return b


CASES = ("chromosomes", "max_intron", "ties", "big_clusters", "long_reads",
         "empty", "past_2_31")


def _pair(genome, index, params):
    """The host path's aligner and the card path's (plain versions on the
    CPU), each on one native thread, as the suite runs beside others."""
    return [TorchBatchAligner(genome, params, index=index, device="cpu",
                              junction_backend="host", seed_lookup=sl,
                              n_threads=1)
            for sl in (False, True)]


def _aligners(index):
    genome = Genome(["g"], np.zeros(1000, np.uint8),
                    np.array([0, 1000], np.int64))
    return _pair(genome, index, AlignParams(
        k=index.k, w=5, chain=ChainParams(max_intron=MAX_INTRON)))


def assert_same_rows(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (a.read_i, a.strand, a.base, a.n_big, a.q_max) == \
            (b.read_i, b.strand, b.base, b.n_big, b.q_max)
        assert type(b.base) is type(b.n_big) is type(b.q_max) is int
        assert a.qpos.dtype == b.qpos.dtype == b.gpos.dtype == np.int64
        np.testing.assert_array_equal(a.qpos, b.qpos)
        np.testing.assert_array_equal(a.gpos, b.gpos)


def _rows(case, monkeypatch, cap):
    index, mins = _case(case).build()
    host, card = _aligners(index)
    for al in (host, card):
        monkeypatch.setattr(al, "_batch_minimizers", lambda reads: mins)
    monkeypatch.setattr(seed_device, "SELECT_CAP", cap)
    reads = [np.zeros(n, np.uint8) for n in mins[4]]
    assert card._seed_lookup.selects(len(reads), max(mins[4]))
    reset_spans()
    try:
        with tracing():
            want = host._batch_anchors(reads)
            ctr_host = counter_totals()
        reset_spans()
        with tracing():
            got = card._batch_anchors(reads)
            ctr_card = counter_totals()
    finally:
        reset_spans()
        host.close()
        card.close()
    return want, got, ctr_host, ctr_card, mins


@pytest.mark.parametrize("cap", [SELECT_CAP, 40])
@pytest.mark.parametrize("case", CASES)
def test_rows_equal_host_path(case, cap, monkeypatch):
    want, got, ctr_host, ctr_card, mins = _rows(case, monkeypatch, cap)
    assert_same_rows(want, got)
    if case != "empty":
        assert len(want) > 0
    for name in ("lookup_queries", "hits"):
        key = "lr2rmats.align." + name
        assert ctr_card[key] == ctr_host[key]
    hosted = ctr_card["lr2rmats.align.seed_host_reads"]
    card_hits = ctr_card["lr2rmats.align.hits_card"]
    assert 0 <= hosted <= len(mins[4])
    assert 0 <= card_hits <= ctr_card["lr2rmats.align.hits"]
    if cap == SELECT_CAP:
        assert hosted == 0
        assert card_hits == ctr_card["lr2rmats.align.hits"]


def _inputs(n_reads=3, cap=SELECT_CAP):
    t = {"table": torch.arange(10, dtype=torch.int64),
         "chrom_off": torch.tensor([0, 100], dtype=torch.int64),
         "lo": torch.zeros(4, dtype=torch.int32),
         "cs": torch.tensor([1, 2, 3, 4], dtype=torch.int64),
         "hoff": torch.tensor([0, 2, 4, 4], dtype=torch.int64),
         "qoff": torch.tensor([0, 2, 4, 4], dtype=torch.int32),
         "qpack": torch.zeros(4, dtype=torch.int32),
         "read_len": torch.full((n_reads,), 50, dtype=torch.int32)}
    return t


def test_select_checks_its_inputs():
    t = _inputs()
    meta, out = seed_select(*t.values(), 15, 1000, 500, A_MAX)
    assert meta.shape == (3, META) and out.shape == (4,)
    bad = dict(t, lo=t["lo"].long())
    with pytest.raises(ValueError, match="lo must be"):
        seed_select(*bad.values(), 15, 1000, 500, A_MAX)
    bad = dict(t, hoff=t["hoff"][:3])
    with pytest.raises(ValueError, match="shapes"):
        seed_select(*bad.values(), 15, 1000, 500, A_MAX)
    with pytest.raises(ValueError, match="cap"):
        seed_select(*t.values(), 15, 1000, 500, A_MAX, cap=SELECT_CAP + 1)
