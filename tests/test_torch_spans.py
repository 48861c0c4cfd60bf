"""The port's spans and counters (lr2rmats_tpu_torch/utils/log.py) at the
layer boundaries of one long-read call (`align_seqset_packed`) and one
short-read batch (`count_pairs_batched`), on the CPU at small synth.py
sizes.

With tracing off a span opens no `torch.profiler.record_function` and
keeps no record, and counters stay empty; the aligner's stats keep their
keys.  With tracing on every span of the call is recorded under the
call's id (worker spans too), the polish and short-read phases sit under
their parent span, the counters count, and the outputs are the same bytes
as with tracing off.
"""

import json

import numpy as np
import pytest
import torch

from lr2rmats_tpu_torch import synth
from lr2rmats_tpu_torch.align import aligner as port_aligner
from lr2rmats_tpu_torch.align import batch as port_batch
from lr2rmats_tpu_torch.align.batch import TorchBatchAligner
from lr2rmats_tpu_torch.io.fasta import Genome, read_fasta
from lr2rmats_tpu_torch.io.gtf import ChrNames, read_anno_trans
from lr2rmats_tpu_torch.junctions.sjcount import (TorchJunctionCounter,
                                                  gather_junctions)
from lr2rmats_tpu_torch.utils.log import (count, counter_totals,
                                          current_call, reset_spans, span,
                                          span_records, span_totals,
                                          tracing, tracing_on)
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)

ALIGN_SPANS = {"lr2rmats.align.call", "lr2rmats.align.seed",
               "lr2rmats.align.prepare", "lr2rmats.align.seed_wait",
               "lr2rmats.align.dispatch", "lr2rmats.align.chain_wait",
               "lr2rmats.align.build", "lr2rmats.align.build_wait",
               "lr2rmats.align.polish"}
POLISH_SPANS = {"lr2rmats.polish.support", "lr2rmats.polish.ties",
                "lr2rmats.polish.windows", "lr2rmats.polish.place",
                "lr2rmats.polish.accept"}
POLISH_COUNTERS = {"lr2rmats.polish." + k for k in (
    "junctions", "winners", "tried", "tasks", "host_dp", "replaced")}
SR_SPANS = {"lr2rmats.sr.call", "lr2rmats.sr.seed", "lr2rmats.sr.verify",
            "lr2rmats.sr.best", "lr2rmats.sr.pair", "lr2rmats.sr.count"}
WORKER_SPANS = {"lr2rmats.align.seed", "lr2rmats.align.prepare",
                "lr2rmats.align.build"}
# spans under the build span, on the build worker
BUILD_SPANS = {"lr2rmats.align.rescue"}
RESCUE_COUNTERS = {"lr2rmats.align.rescue_clips",
                   "lr2rmats.align.rescue_placed"}
READS = 300
BATCH = 150                       # two batches


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    # at 6% errors polish re-places junctions, some on the device path
    synth.simulate_dataset(str(d), genome_mb=0.5, genes=10,
                           long_reads=READS, short_pairs=1200,
                           long_err=0.06, seed=11)
    return d


@pytest.fixture(scope="module")
def aligner(dataset):
    al = TorchBatchAligner(Genome.load(str(dataset / "genome.fa")),
                           device="cpu", junction_backend="host",
                           seed_lookup=False)
    yield al
    al.close()


class _Align:
    """One `align_seqset_packed` call on two batches; its SAM bytes."""
    call = "lr2rmats.align.call"
    spans = ALIGN_SPANS | POLISH_SPANS | BUILD_SPANS

    def __init__(self, dataset, aligner):
        self.al = aligner
        self.reads = read_fasta(str(dataset / "long.fa"))

    def run(self):
        self.al.stats = self.al.fresh_stats()
        rb = self.al.align_seqset_packed(self.reads, BATCH)
        return rb.emit_sam(self.al.refs)


class _ShortReads:
    """One `count_pairs_batched` batch on a fresh counter; its counts."""
    call = "lr2rmats.sr.call"
    spans = SR_SPANS

    def __init__(self, dataset, aligner):
        genome = aligner.inner.genome
        anno = read_anno_trans(str(dataset / "anno.gtf"),
                               ChrNames(genome.names))
        self.genome = genome
        self.introns = gather_junctions([anno])
        self.pairs = (read_fasta(str(dataset / "short_1.fa")),
                      read_fasta(str(dataset / "short_2.fa")))

    def run(self):
        jc = TorchJunctionCounter(self.genome, *self.introns, device="cpu")
        jc.count_pairs_batched(*self.pairs)
        t = jc.result()
        return (t.uniq_c.tobytes() + t.multi_c.tobytes() +
                t.max_over.tobytes())


KINDS = {"align": _Align, "short_reads": _ShortReads}


@pytest.fixture(params=sorted(KINDS))
def entry(request, dataset, aligner, monkeypatch):
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", "1")
    monkeypatch.delenv("LR2RMATS_NO_POLISH", raising=False)
    reset_spans()
    yield KINDS[request.param](dataset, aligner)
    reset_spans()


def _by_id():
    return {r["id"]: r for r in span_records()}


def test_tracing_off_records_nothing(entry, monkeypatch):
    """Off: no record_function call, no record, no counter."""
    def boom(*a, **k):
        raise AssertionError("record_function called with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not tracing_on()
    out = entry.run()
    assert out
    assert span_records() == [] and counter_totals() == {}
    assert span_totals() == {}


def test_output_same_with_tracing(entry):
    """The outputs are the same bytes with tracing on and off."""
    off = entry.run()
    with tracing():
        on = entry.run()
    assert on == off
    assert entry.call in span_totals()


def test_spans_of_a_call(entry):
    """On: every span of the call, each under the call's id; the phases
    under their parent span; the counters count."""
    with tracing():
        entry.run()
    recs = span_records()
    names = {r["name"] for r in recs}
    assert entry.spans <= names, entry.spans - names
    calls = [r for r in recs if r["name"] == entry.call]
    assert len(calls) == 1
    cid = calls[0]["id"]
    assert calls[0]["call"] == cid and calls[0]["parent"] is None
    assert all(r["call"] == cid for r in recs)
    by_id = _by_id()
    for r in recs:
        assert r["start"] <= r["end"]
        if r["name"] in BUILD_SPANS:
            assert by_id[r["parent"]]["name"] == "lr2rmats.align.build"
            assert r["thread"] != calls[0]["thread"]
        elif r["name"] != entry.call and r["name"] not in WORKER_SPANS:
            # main-thread spans nest under the call
            assert r["parent"] is not None
            assert r["thread"] == calls[0]["thread"]
            p = r
            while p["parent"] is not None:
                p = by_id[p["parent"]]
            assert p["id"] == cid
    totals = span_totals()
    assert totals[entry.call][1] == 1
    ctr = counter_totals()
    if entry.call == "lr2rmats.sr.call":
        for r in recs:
            if r["name"] in ("lr2rmats.sr.seed", "lr2rmats.sr.verify",
                             "lr2rmats.sr.best"):
                assert totals[r["name"]][1] == 2          # one a mate
        assert ctr["lr2rmats.sr.candidates"] > 0
        assert ctr["lr2rmats.sr.combos"] > 0
        return
    for r in recs:
        if r["name"] in WORKER_SPANS:
            assert r["parent"] is None
            assert r["thread"] != calls[0]["thread"]
        if r["name"] in POLISH_SPANS:
            assert by_id[r["parent"]]["name"] == "lr2rmats.align.polish"
    for name in ("lr2rmats.align.seed", "lr2rmats.align.prepare",
                 "lr2rmats.align.build", "lr2rmats.align.seed_wait",
                 "lr2rmats.align.dispatch", "lr2rmats.align.chain_wait"):
        assert totals[name][1] == 2, name                 # one a batch
    assert ctr["lr2rmats.align.batches"] == 2
    assert totals["lr2rmats.align.rescue"][1] == 2            # one a batch
    assert RESCUE_COUNTERS <= set(ctr)
    assert 0 <= ctr["lr2rmats.align.rescue_placed"] <= \
        ctr["lr2rmats.align.rescue_clips"]
    assert POLISH_COUNTERS <= set(ctr)
    assert 0 < ctr["lr2rmats.polish.winners"] <= \
        ctr["lr2rmats.polish.junctions"]
    assert 0 < ctr["lr2rmats.polish.replaced"] <= \
        ctr["lr2rmats.polish.tried"]
    assert 0 < ctr["lr2rmats.polish.tasks"] <= ctr["lr2rmats.polish.tried"]
    # the aligner gives polish its device: no task placed there runs the
    # host DP again
    assert ctr["lr2rmats.polish.host_dp"] <= \
        ctr["lr2rmats.polish.tried"] - ctr["lr2rmats.polish.tasks"]


@pytest.mark.parametrize("traced", [False, True])
def test_stats_keep_their_meaning(dataset, aligner, monkeypatch, traced):
    """The stats keys the spans feed are there and positive, on or off,
    and seed_s holds the seed and prepare spans."""
    entry = _Align(dataset, aligner)
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", "1")
    reset_spans()
    if traced:
        with tracing():
            entry.run()
    else:
        entry.run()
    st = aligner.stats
    for key in ("seed_s", "dispatch_s", "build_s", "polish_s"):
        assert st[key] > 0, key
    if traced:
        t = span_totals()
        for key, names in (("seed_s", ("seed", "prepare")),
                           ("dispatch_s", ("dispatch",)),
                           ("build_s", ("build",)),
                           ("polish_s", ("polish",))):
            spanned = sum(t["lr2rmats.align." + n][0] for n in names)
            assert st[key] == pytest.approx(spanned, rel=1e-9), key
    reset_spans()


def test_span_helper():
    """Nesting, call ids across threads, counters only while tracing,
    totals, and the owner's stats with tracing off."""
    import threading

    class Owner:
        def __init__(self):
            self.stats = {}

        def _add_stats(self, **inc):
            for k, v in inc.items():
                self.stats[k] = self.stats.get(k, 0) + v

    reset_spans()
    own = Owner()
    with span("t.off", own, "x_s"):
        count("t.n", 3)
        assert current_call() is None
    assert own.stats["x_s"] > 0 and span_records() == []
    assert counter_totals() == {}
    with tracing():
        assert tracing_on()
        with span("t.call") as outer:
            cid = current_call()
            with span("t.inner"):
                count("t.n", 2)
            seen = []
            th = threading.Thread(target=lambda: seen.append(
                span("t.worker", call=cid).__enter__().__exit__()))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        count("t.n", 1)
    assert not tracing_on()
    assert cid == outer._id
    recs = {r["name"]: r for r in span_records()}
    assert recs["t.inner"]["parent"] == cid
    assert recs["t.worker"]["call"] == cid
    assert recs["t.worker"]["parent"] is None
    assert counter_totals() == {"t.n": 3}
    tot = span_totals()
    assert set(tot) == {"t.call", "t.inner", "t.worker"}
    assert tot["t.call"][0] >= tot["t.inner"][0]
    reset_spans()
    assert span_records() == [] and counter_totals() == {}


def test_rescue_span_and_counters_only_under_a_profiler(dataset, aligner,
                                                       monkeypatch):
    """The terminal-exon rescue's span and counters: nothing without a
    profiler; under one, one span a batch under the build span and both
    counters, the clips those the host version seeds."""
    entry = _Align(dataset, aligner)
    monkeypatch.setenv("LR2RMATS_SEED_WORKERS", "1")
    reset_spans()
    off = entry.run()
    assert span_records() == [] and counter_totals() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = entry.run()
    assert on == off
    recs = [r for r in span_records() if r["name"] in BUILD_SPANS]
    assert len(recs) == 2
    by_id = _by_id()
    assert all(by_id[r["parent"]]["name"] == "lr2rmats.align.build"
               for r in recs)
    ctr = counter_totals()
    assert RESCUE_COUNTERS <= set(ctr)
    # the host version, one read at a time, seeds as many clips
    seen = [0]
    real = port_aligner.extract_minimizers

    def counted(*a, **k):
        seen[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(port_aligner, "extract_minimizers", counted)
    monkeypatch.setattr(port_batch, "get_lib", lambda: None)
    reset_spans()
    entry.run()
    assert counter_totals() == {}
    assert ctr["lr2rmats.align.rescue_clips"] == seen[0] > 0
    assert ctr["lr2rmats.align.rescue_placed"] <= seen[0]
    reset_spans()


def test_profiler_turns_tracing_on(tmp_path):
    """A recording torch profiler turns tracing on, and the main thread's
    spans land in its Chrome trace."""
    reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing_on()
        with span("lr2rmats.test.call"):
            torch.ones(4).sum()
    assert not tracing_on()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "lr2rmats.test.call" in names
    assert set(span_totals()) == {"lr2rmats.test.call"}
    reset_spans()
