"""The readers of the program's spans and counters
(cardbench/program_spans.py): each gives its formula on a hand-filled
registry, and None without its span or counter, in a cell of the other
kind, and against a program that has no spans at all."""

import glob
import importlib
import json
import os

import pytest

from cardbench import run

# the module (the package's `utils.log` name is the log function)
LOG = importlib.import_module("lr2rmats_tpu_torch.utils.log")
ALIGN = {"entry": "align", "long_reads": 20000}
SR = {"entry": "sr_count", "short_reads": 400000}
# metric -> (span, record, value for 2.0 s of the span)
SPANS = {
    "prepare_us_per_read": ("lr2rmats.align.prepare", ALIGN, 100.0),
    "seed_wait_us_per_read": ("lr2rmats.align.seed_wait", ALIGN, 100.0),
    "chain_wait_us_per_read": ("lr2rmats.align.chain_wait", ALIGN, 100.0),
    "build_wait_us_per_read": ("lr2rmats.align.build_wait", ALIGN, 100.0),
    "polish_support_us_per_read": ("lr2rmats.polish.support", ALIGN, 100.0),
    "polish_ties_us_per_read": ("lr2rmats.polish.ties", ALIGN, 100.0),
    "polish_windows_us_per_read": ("lr2rmats.polish.windows", ALIGN, 100.0),
    "polish_place_us_per_read": ("lr2rmats.polish.place", ALIGN, 100.0),
    "polish_accept_us_per_read": ("lr2rmats.polish.accept", ALIGN, 100.0),
    "sr_seed_us_per_kread": ("lr2rmats.sr.seed", SR, 5000.0),
    "sr_verify_us_per_kread": ("lr2rmats.sr.verify", SR, 5000.0),
    "sr_best_us_per_kread": ("lr2rmats.sr.best", SR, 5000.0),
    "sr_pair_us_per_kread": ("lr2rmats.sr.pair", SR, 5000.0),
    "sr_count_us_per_kread": ("lr2rmats.sr.count", SR, 5000.0),
}


def _registry(monkeypatch, spans=None, counters=None):
    monkeypatch.setattr(LOG, "span_totals", lambda: dict(spans or {}))
    monkeypatch.setattr(LOG, "counter_totals", lambda: dict(counters or {}))


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader(name, monkeypatch):
    span, rec, want = SPANS[name]
    read = run.reader(name)
    _registry(monkeypatch, {span: (2.0, 7), "lr2rmats.other": (9.0, 1)})
    assert read(dict(rec)) == pytest.approx(want)
    other = SR if rec is ALIGN else ALIGN
    assert read(dict(other)) is None              # no reads of its kind
    _registry(monkeypatch, {"lr2rmats.other": (9.0, 1)})
    assert read(dict(rec)) is None                # no such span
    monkeypatch.delattr(LOG, "span_totals")
    assert read(dict(rec)) is None                # a program without spans


@pytest.mark.parametrize("counters, want", [
    ({"lr2rmats.polish.tried": 400, "lr2rmats.polish.replaced": 100}, 0.25),
    ({"lr2rmats.polish.tried": 400}, 0.0),
    ({"lr2rmats.polish.replaced": 100}, None),
    ({"lr2rmats.polish.tried": 0, "lr2rmats.polish.replaced": 0}, None),
    ({}, None)])
def test_replaced_share(counters, want, monkeypatch):
    read = run.reader("polish_replaced_share")
    _registry(monkeypatch, counters=counters)
    got = read(dict(ALIGN))
    assert got == (None if want is None else pytest.approx(want))
    assert read(dict(SR)) is None
    monkeypatch.delattr(LOG, "counter_totals")
    assert read(dict(ALIGN)) is None


def test_every_span_metric_has_a_case():
    """Every metric whose reader takes the program's spans or counters is
    in BENCHMARK.json and has a case here."""
    here = os.path.join(run.ROOT, "cardbench", "metrics")
    readers = {os.path.basename(p)[:-3]
               for p in glob.glob(os.path.join(here, "*.py"))
               if "program_spans" in open(p).read()}
    assert readers == set(SPANS) | {"polish_replaced_share"}
    man = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    assert readers <= {m["name"] for m in man["per_layer"]}


def test_real_registry():
    """The readers read what the program's spans and counters record."""
    LOG.reset_spans()
    with LOG.tracing():
        with LOG.span("lr2rmats.align.seed_wait"):
            pass
        LOG.count("lr2rmats.polish.tried", 4)
        LOG.count("lr2rmats.polish.replaced", 1)
    try:
        assert run.reader("seed_wait_us_per_read")(dict(ALIGN)) >= 0
        assert run.reader("polish_replaced_share")(dict(ALIGN)) == 0.25
        assert run.reader("build_wait_us_per_read")(dict(ALIGN)) is None
    finally:
        LOG.reset_spans()
