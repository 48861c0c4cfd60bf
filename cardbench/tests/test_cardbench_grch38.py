"""The whole-genome cell `grch38_isoseq_genome`: found by name with its
configuration, limits and readers; a miniature of it (every chromosome
at 1/500 of its length, every width kept) judged `correct` on the CPU,
and not correct with a fault planted in the device seed lookup or with
the bfloat16 control in the aligner's place; and each of its four new
readers on hand-filled records."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from cardbench import control, run
from lr2rmats_tpu_torch.index.seed_device import TorchSeedLookup

CELL = "grch38_isoseq_genome"
NEW = ("seed_lookup_us_per_read", "seed_hits_per_read",
       "host_chain_anchor_share", "seed_lookup_roofline")
SEED = 2**31 + 38
MAN = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
LOG = importlib.import_module("lr2rmats_tpu_torch.utils.log")


def mini_cell(scale: int = 500) -> dict:
    """The cell with every chromosome `scale` times shorter (6.2 Mb in
    all at 500), as many pasted repeats a base, calls of 96 reads."""
    spec = run.load_cell(CELL)
    cfg = spec["config"]
    for c in cfg["chromosomes"]:
        c["length"] = int(c["length"]) // scale
    cfg["profile"]["repeats"] = max(1, cfg["profile"]["repeats"] // scale)
    cfg["reads_per_call"] = 96
    return spec


def test_cell_is_found():
    spec = run.load_cell(CELL)
    cfg = spec["config"]
    assert cfg["name"] == "grch38_isoseq" and spec["chips"] == 1
    assert len(cfg["chromosomes"]) == 24
    assert sum(c["length"] for c in cfg["chromosomes"]) == 3_088_269_832
    assert cfg["aligner"]["seed_lookup"] is True
    assert cfg["profile"]["name"] == "isoseq"
    assert spec["traffic"]["entry"] == "align"
    assert set(spec["limits"]) == {"bad_records", "misplaced_pct",
                                   "introns_missed_pct", "score_deficit_pct"}
    assert spec["limits"]["bad_records"] == 0
    assert spec["limits"]["misplaced_pct"] <= 1.0
    assert spec["limits"]["introns_missed_pct"] <= 1.0
    conf = {c["name"]: c for c in MAN["configs"]}["grch38_isoseq"]
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"]) == \
        ["index_shards", "reads_per_call"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert e2e == {"long_reads_per_s", "peak_rss_gib", "setup_s"}
    layer = {m["name"]: m for m in spec["per_layer"]}
    assert set(NEW) <= set(layer)
    for name in NEW:
        assert layer[name]["workloads"] == [CELL]
        assert layer[name]["moves"] == "long_reads_per_s"
        assert callable(run.reader(name))
    assert layer["seed_lookup_roofline"]["unit"] == "%"
    # the align metrics the cell shares with the other align cells
    assert {"seed_us_per_read", "chain_kernel_us_per_read",
            "device_idle_share.align"} <= set(layer)


def _run(trace=False):
    return run.run_cell(mini_cell(), SEED, 0.3, trace, device="cpu")


def test_miniature_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert {"long_reads_per_s", "setup_s", "peak_rss_gib"} <= \
        set(out["metrics"])
    assert out["detail"]["reads_judged"] > 0


def test_miniature_traced_reports_the_seed_metrics():
    """Traced on the CPU: the span and counter readers read the program;
    the roofline needs the card's kernel timer and stays out."""
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["seed_lookup_us_per_read"]["value"] > 0
    assert got["seed_hits_per_read"]["value"] > 0
    assert 0 <= got["host_chain_anchor_share"]["value"] <= 1
    assert "seed_lookup_roofline" not in got


def test_lookup_fault_is_not_correct(monkeypatch):
    """Every range the device lookup returns one shorter at its top."""
    orig = TorchSeedLookup.lookup

    def lookup(self, q):
        lo, hi = orig(self, q)
        return lo, hi - 1
    monkeypatch.setattr(TorchSeedLookup, "lookup", lookup)
    out = _run()
    assert not out["correct"], out["checks"]


def test_control_fails_miniature():
    spec = mini_cell()
    spec["config"]["reads_per_call"] = 24
    out = control.align_control(spec, 11, torch.device("cpu"))
    assert not out["correct"], out
    assert out["misplaced_pct"] > spec["limits"]["misplaced_pct"]
    assert out["introns_missed_pct"] > spec["limits"]["introns_missed_pct"]


ALIGN = {"entry": "align", "long_reads": 20000}
SR = {"entry": "sr_count", "short_reads": 400000}


def _registry(monkeypatch, spans=None, counters=None):
    monkeypatch.setattr(LOG, "span_totals", lambda: dict(spans or {}))
    monkeypatch.setattr(LOG, "counter_totals", lambda: dict(counters or {}))


@pytest.mark.parametrize("name, spans, counters, rec, want", [
    ("seed_lookup_us_per_read", {"lr2rmats.align.seed_lookup": (0.5, 9)},
     {}, ALIGN, 25.0),
    ("seed_hits_per_read", {}, {"lr2rmats.align.hits": 5_000_000},
     ALIGN, 250.0),
    ("host_chain_anchor_share", {},
     {"lr2rmats.align.anchors": 400, "lr2rmats.align.anchors_host": 100},
     ALIGN, 0.25),
    ("host_chain_anchor_share", {}, {"lr2rmats.align.anchors": 400},
     ALIGN, 0.0),
    # 1e9 queries need 76 GB: 22.686 ms at 3.35 TB/s, so 226.86 ms is 10%
    ("seed_lookup_roofline", {}, {"lr2rmats.align.lookup_queries": 10**9},
     {**ALIGN, "kernel_ms": {"seed_lookup": 76e9 / 3.35e12 * 1e3 * 10}},
     10.0),
])
def test_new_reader(name, spans, counters, rec, want, monkeypatch):
    read = run.reader(name)
    _registry(monkeypatch, spans, counters)
    assert read(dict(rec)) == pytest.approx(want)
    assert read(dict(SR)) is None                 # no long reads
    _registry(monkeypatch)
    assert read(dict(rec)) is None                # nothing recorded
    monkeypatch.delattr(LOG, "span_totals")
    monkeypatch.delattr(LOG, "counter_totals")
    assert read(dict(rec)) is None                # a program without them


def test_roofline_needs_the_kernel_timer(monkeypatch):
    read = run.reader("seed_lookup_roofline")
    _registry(monkeypatch, counters={"lr2rmats.align.lookup_queries": 10})
    assert read(dict(ALIGN)) is None
    assert read({**ALIGN, "kernel_ms": {"chain_dp": 1.0}}) is None
    assert np.isclose(read({**ALIGN, "kernel_ms": {"seed_lookup": 1.0}}),
                      100.0 * 760 / 3.35e12 / 1e-3)
