"""The hit selection on the device (index/seed_device.py `seed_select`,
plain PyTorch on the CPU) against the host path of align/batch.py
`_batch_anchors` on a saturated 24-chromosome deployment
(tests/test_torch_seed_genome.py):

  * with a budget of the median read's hits, the reads over it take the
    host path alone: the same rows, and hits_card plus those reads' hits
    equal hits;
  * rows, anchors and their counters equal the host path's;
  * `align_seqset_packed` with one and two seed workers, with and without
    reads over the budget: the SAM bytes of the host backend;
  * positions at or past 2^32: no packed table, the host path.
"""

import numpy as np
import pytest

from lr2rmats_tpu_torch.align.aligner import AlignParams
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.index import seed_device
from lr2rmats_tpu_torch.index.minimizer import MinimizerIndex
from lr2rmats_tpu_torch.index.seed_device import SELECT_CAP
from lr2rmats_tpu_torch.utils.log import counter_totals, reset_spans, tracing
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_seed_genome import (BATCH, K, READS, W,  # noqa: F401
                                          deployment)
from tests.test_torch_seed_select import _pair, assert_same_rows


def test_overflow_reads_take_the_host_path(deployment, monkeypatch):
    """With a budget of the median read's hits, about half the reads take
    the host path: the same rows, and hits_card plus the hits of those
    reads (their ranges, as the host path received them) equal hits."""
    _, genome, index, reads = deployment
    codes = [reads.get(i) for i in range(BATCH)]
    host, card = _pair(genome, index, AlignParams(k=K, w=W))
    seen = []
    orig = card._seed_lookup.select

    def select(*args, **kw):
        seen.append(orig(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(card._seed_lookup, "select", select)
    try:
        card._batch_anchors(codes)
        cap = int(np.median(seen[0].read_hits))
        monkeypatch.setattr(seed_device, "SELECT_CAP", cap)
        reset_spans()
        with tracing():
            got = card._batch_anchors(codes)
            ctr = counter_totals()
        want = host._batch_anchors(codes)
    finally:
        reset_spans()
        host.close()
        card.close()
    assert_same_rows(want, got)
    sel = seen[-1]
    left = sel.meta[:, 0] < 0
    assert np.array_equal(left, sel.read_hits > cap)
    assert 0 < left.sum() < BATCH
    assert ctr["lr2rmats.align.seed_host_reads"] == left.sum()
    host_hits = int((sel.host_hi - sel.host_lo).sum())
    assert host_hits == int(sel.read_hits[left].sum()) > 0
    assert (ctr["lr2rmats.align.hits_card"] + host_hits ==
            ctr["lr2rmats.align.hits"])
    assert {int(r) for r in np.nonzero(left)[0]} <= \
        {r.read_i for r in want}


def test_rows_counter_equals_host_path(deployment, monkeypatch):
    """On the saturated deployment: rows, anchors and their counters of
    the card path equal the host path's, batch by batch."""
    _, genome, index, reads = deployment
    host, card = _pair(genome, index, AlignParams(k=K, w=W))
    codes = [reads.get(i) for i in range(BATCH)]
    totals = []
    try:
        for al in (host, card):
            reset_spans()
            with tracing():
                rows = al._batch_anchors(codes)
                al._prepare_dispatch(rows)
            totals.append((rows, counter_totals()))
    finally:
        reset_spans()
        host.close()
        card.close()
    (want, ch), (got, cc) = totals
    assert_same_rows(want, got)
    for name in ("lookup_queries", "hits", "rows", "anchors",
                 "anchors_host"):
        key = "lr2rmats.align." + name
        assert cc[key] == ch[key], name
    assert cc["lr2rmats.align.hits_card"] == cc["lr2rmats.align.hits"]
    assert cc["lr2rmats.align.seed_host_reads"] == 0
    assert "lr2rmats.align.hits_card" not in ch


@pytest.mark.parametrize("cap", [SELECT_CAP, 300])
@pytest.mark.parametrize("workers", ["1", "2"])
def test_sam_equals_host_backend(deployment, monkeypatch, workers, cap):
    """One and two seed workers, with and without reads over the budget:
    the SAM bytes of the host backend, and one selection a batch."""
    _, genome, index, reads = deployment
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", workers)
    monkeypatch.setattr(seed_device, "SELECT_CAP", cap)
    host, card = _pair(genome, index, AlignParams(k=K, w=W))
    selects = []
    orig = card._seed_lookup.select

    def select(*args, **kw):
        out = orig(*args, **kw)
        selects.append(int((out.meta[:, 0] < 0).sum()))
        return out

    monkeypatch.setattr(card._seed_lookup, "select", select)
    try:
        want = host.align_seqset_packed(reads, BATCH).emit_sam(host.refs)
        got = card.align_seqset_packed(reads, BATCH).emit_sam(card.refs)
    finally:
        host.close()
        card.close()
    assert got.count(b"\n") > READS
    assert got == want
    assert len(selects) == -(-READS // BATCH)
    assert (sum(selects) > 0) == (cap < SELECT_CAP)


def test_host_path_where_the_key_does_not_fit(deployment, monkeypatch):
    """Positions at or past 2^32: no packed table, the lookup's ranges
    come back and the host path groups them."""
    _, genome, index, reads = deployment
    moved = MinimizerIndex(
        K, W, index.hashes, index.pos + 2**32, index.strand,
        np.concatenate([[0], index.chrom_offsets + 2**32]),
        ["pad"] + list(index.names), index.max_occ)
    al = TorchBatchAligner(genome, AlignParams(k=K, w=W), index=moved,
                           device="cpu", seed_lookup=True, n_threads=1)
    assert al._seed_lookup.packed is None
    assert not al._seed_lookup.selects(1, 100)
    calls = []
    monkeypatch.setattr(al._seed_lookup, "select",
                        lambda *a, **k: calls.append(1))
    rows = al._batch_anchors([reads.get(i) for i in range(8)])
    al.close()
    assert rows and not calls
    assert al._seed_lookup.calls == 1
