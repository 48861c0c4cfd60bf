"""The readers of the terminal-exon rescue's counter and span: each gives
its formula on a hand-filled registry, and None without its counter or
span, in a cell of the other kind, and against a program that has no
spans at all; both are listed for the three long-read cells."""

import importlib
import json
import os

import pytest

from cardbench import run

LOG = importlib.import_module("lr2rmats_tpu_torch.utils.log")
ALIGN = {"entry": "align", "long_reads": 20000}
SR = {"entry": "sr_count", "short_reads": 400000}
LONG_CELLS = ["chr21_ont_deep", "yeast_ont_align", "grch38_isoseq_genome"]
# metric -> (registry that reads want, want, registry of the other name)
CASES = {
    "rescue_clips_per_read": (
        ({}, {"lr2rmats.align.rescue_clips": 6000}), 0.3,
        ({}, {"lr2rmats.align.rescue_placed": 6000})),
    "build_rescue_us_per_read": (
        ({"lr2rmats.align.rescue": (0.5, 13)}, {}), 25.0,
        ({"lr2rmats.align.build": (0.5, 13)}, {})),
}


def _registry(monkeypatch, spans, counters):
    monkeypatch.setattr(LOG, "span_totals", lambda: dict(spans))
    monkeypatch.setattr(LOG, "counter_totals", lambda: dict(counters))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rescue_reader(name, monkeypatch):
    reg, want, other = CASES[name]
    read = run.reader(name)
    _registry(monkeypatch, *reg)
    assert read(dict(ALIGN)) == pytest.approx(want)
    assert read(dict(SR)) is None                 # no long reads
    _registry(monkeypatch, *other)
    assert read(dict(ALIGN)) is None              # no such counter or span
    monkeypatch.delattr(LOG, "span_totals")
    monkeypatch.delattr(LOG, "counter_totals")
    assert read(dict(ALIGN)) is None              # a program without them


def test_rescue_clips_zero_reads_zero(monkeypatch):
    """A window whose batches seeded no clip reads 0, not None."""
    _registry(monkeypatch, {}, {"lr2rmats.align.rescue_clips": 0})
    assert run.reader("rescue_clips_per_read")(dict(ALIGN)) == 0.0


@pytest.mark.parametrize("name", sorted(CASES))
def test_rescue_metric_in_manifest(name):
    man = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    m = {x["name"]: x for x in man["per_layer"]}[name]
    assert m["workloads"] == LONG_CELLS
    assert m["moves"] == "long_reads_per_s"
    assert m["layer"] == "extension + RecordBatch, host (_build_packed)"
    for cell in LONG_CELLS:
        assert name in {x["name"] for x in run.load_cell(cell)["per_layer"]}
    assert name not in {x["name"] for x in
                        run.load_cell("chr21_sr_count")["per_layer"]}
