"""Whole runs on the CPU, at a small size, with the card check skipped:
sound runs come out correct, and runs with the timed path broken
underneath come out not correct."""

import numpy as np
import pytest

from cardbench import run
from lr2rmats_tpu_torch.align import polish
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.align.records import RecordBatch
from lr2rmats_tpu_torch.io.fasta import SeqSet
from lr2rmats_tpu_torch.io.sam import OP_M
from lr2rmats_tpu_torch.junctions.sjcount import TorchJunctionCounter
from lr2rmats_tpu_torch.junctions.sjcount_device import TorchCounts

from .small import small_cell

SEED = 2**31 + 101


def _half(s):
    h = s.n // 2
    return SeqSet(s.names[:h], s.codes[: s.offsets[h]], s.offsets[: h + 1])


def _align_half(monkeypatch):
    orig = TorchBatchAligner.align_seqset_packed
    monkeypatch.setattr(TorchBatchAligner, "align_seqset_packed",
                        lambda self, s, *a, **k: orig(self, _half(s), *a,
                                                      **k))


def _align_altered(monkeypatch):
    orig = RecordBatch.emit_sam

    def emit(self, refs):
        self.cig_buf = self.cig_buf.copy()
        self.cig_buf[self.cig_offs[0]] += 1 << 4   # first op one longer
        return orig(self, refs)
    monkeypatch.setattr(RecordBatch, "emit_sam", emit)


def _chain_lost(monkeypatch):
    """Every twentieth chain row comes back from the chain stage with no
    chain: about 5% of the reads lose the chain that places them."""
    orig = TorchBatchAligner._materialize_chains

    def chains(self, rows, pending):
        out = orig(self, rows, pending)
        empty = np.zeros(0, np.int64)
        return [(empty, 0.0, empty, 0.0) if i % 20 == 0 else c
                for i, c in enumerate(out)]
    monkeypatch.setattr(TorchBatchAligner, "_materialize_chains", chains)


def _polish_shifted(monkeypatch):
    """Every junction that polish re-places lands one base to the right of
    the placement its DP chose (the read's split moves with it)."""
    orig = polish._constrained_place

    def place(*a, **k):
        res = orig(*a, **k)
        if res is None:
            return res
        sc, lops, rops, match, nm = res
        lops, rops = list(lops), list(rops)
        i = next((t for t, (op, n) in enumerate(rops) if n), None)
        if lops and i is not None and lops[-1][0] == OP_M and \
                rops[i][0] == OP_M and rops[i][1] > 1:
            lops[-1] = (OP_M, lops[-1][1] + 1)
            rops[i] = (OP_M, rops[i][1] - 1)
        return sc, lops, rops, match, nm
    monkeypatch.setattr(polish, "_constrained_place", place)


def _sr_unchanged(monkeypatch):
    monkeypatch.setattr(TorchJunctionCounter, "count_pairs_batched",
                        lambda self, a, b: None)


def _sr_half(monkeypatch):
    orig = TorchJunctionCounter.count_pairs_batched
    monkeypatch.setattr(TorchJunctionCounter, "count_pairs_batched",
                        lambda self, a, b: orig(self, _half(a), _half(b)))


def _sr_altered(monkeypatch):
    orig = TorchCounts.add

    def add(self, cc, u, over):
        cc = np.array(cc, copy=True)
        if len(cc):
            cc[0] = (cc[0] + 1) % self.n
        return orig(self, cc, u, over)
    monkeypatch.setattr(TorchCounts, "add", add)


def _run(cell, reads=None):
    spec = small_cell(cell)
    if reads:
        spec["config"]["reads_per_call"] = reads
    return run.run_cell(spec, SEED, 0.3, False, device="cpu")


@pytest.mark.parametrize("cell,reads", [("chr21_ont_deep", None),
                                        ("chr21_ont_deep", 768),
                                        ("yeast_ont_align", None),
                                        ("chr21_sr_count", None)])
def test_sound_run_is_correct(cell, reads):
    out = _run(cell, reads)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert {"setup_s", "peak_rss_gib"} <= set(out["metrics"])


# polish re-places a junction only where reads pile up on it: its fault
# runs 128 reads a gene, as the cell does
@pytest.mark.parametrize("cell,fault,reads", [
    ("chr21_ont_deep", _align_half, None),
    ("chr21_ont_deep", _align_altered, None),
    ("chr21_ont_deep", _chain_lost, None),
    ("chr21_ont_deep", _polish_shifted, 768),
    ("chr21_sr_count", _sr_unchanged, None),
    ("chr21_sr_count", _sr_half, None),
    ("chr21_sr_count", _sr_altered, None)])
def test_broken_run_is_not_correct(cell, fault, reads, monkeypatch):
    fault(monkeypatch)
    out = _run(cell, reads)
    assert not out["correct"], out["checks"]
