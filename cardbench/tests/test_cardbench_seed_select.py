"""The seed selection on the card in the whole-genome cell: the reader of
`seed_card_hit_share` on hand-filled counters and on a program without
them; in the traced 1/500 miniature of `grch38_isoseq_genome` on the CPU
(the selection's plain version), every hit selected on the device; and a
fault planted in the ranges the device selects from (every range one
shorter at its top) reads not correct."""

import importlib
import json
import os

import pytest

from cardbench import run
from cardbench.tests.test_cardbench_grch38 import ALIGN, SR, mini_cell
from lr2rmats_tpu_torch.index.seed_device import TorchSeedLookup

CELL = "grch38_isoseq_genome"
NAME = "seed_card_hit_share"
SEED = 2**31 + 19
LOG = importlib.import_module("lr2rmats_tpu_torch.utils.log")


def _registry(monkeypatch, counters=None):
    monkeypatch.setattr(LOG, "span_totals", lambda: {})
    monkeypatch.setattr(LOG, "counter_totals", lambda: dict(counters or {}))


def test_metric_is_declared():
    man = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    m = {x["name"]: x for x in man["per_layer"]}[NAME]
    assert m["workloads"] == [CELL]
    assert m["moves"] == "long_reads_per_s" and m["better"] == "higher"
    assert m["source"] == "program_counter" and m["unit"] == "share"
    assert NAME in {x["name"] for x in run.load_cell(CELL)["per_layer"]}
    assert NAME not in {x["name"] for x in
                        run.load_cell("chr21_ont_deep")["per_layer"]}


@pytest.mark.parametrize("counters, want", [
    ({"lr2rmats.align.hits": 4000, "lr2rmats.align.hits_card": 3960}, 0.99),
    ({"lr2rmats.align.hits": 4000, "lr2rmats.align.hits_card": 0}, 0.0),
    ({"lr2rmats.align.hits": 4000}, None),        # a program without it
    ({"lr2rmats.align.hits_card": 0}, None),
    ({}, None)])
def test_reader(counters, want, monkeypatch):
    read = run.reader(NAME)
    _registry(monkeypatch, counters)
    got = read(dict(ALIGN))
    assert got == (None if want is None else pytest.approx(want))
    assert read(dict(SR)) is None
    monkeypatch.delattr(LOG, "counter_totals")
    assert read(dict(ALIGN)) is None


def test_miniature_selects_every_hit_on_the_device():
    out = run.run_cell(mini_cell(), SEED, 0.3, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME]["value"] == 1.0
    assert out["metrics"]["seed_hits_per_read"]["value"] > 0


def test_range_fault_is_not_correct(monkeypatch):
    orig = TorchSeedLookup._ranges

    def ranges(self, q):
        lo, hi = orig(self, q)
        return lo, (hi - 1).clamp(min=lo)
    monkeypatch.setattr(TorchSeedLookup, "_ranges", ranges)
    out = run.run_cell(mini_cell(), SEED, 0.3, False, device="cpu")
    assert not out["correct"], out["checks"]
