"""A cell, a mix, a configuration, limits and a metric added as files are
found by name, with no file of the harness edited."""

import json
import os
import shutil

from cardbench import run


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(run.ROOT, "cardbench"), root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    cb = root / "cardbench"
    cfg = json.load(open(cb / "configs" / "chr21_ont.json"))
    cfg["name"] = "chr21_clean"
    cfg["profile"] = {**cfg["profile"], "sub": 0.005, "del": 0.0,
                      "ins": 0.0}
    (cb / "configs" / "chr21_clean.json").write_text(json.dumps(cfg))
    (cb / "traffic" / "clean_once.json").write_text(json.dumps(
        {"entry": "align", "why": "one read a gene", "pool_calls": 2}))
    (cb / "limits" / "chr21_clean_once.json").write_text(json.dumps(
        {"bad_records": 0, "score_deficit_pct": 1.0}))
    (cb / "metrics" / "calls_per_s.py").write_text(
        "def read(rec):\n    return rec['calls'] / rec['span_s']\n")
    man["configs"].append({"name": "chr21_clean", "source": "x",
                           "file": "cardbench/configs/chr21_clean.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "chr21_clean_once",
                             "config": "chr21_clean",
                             "traffic": "clean_once", "chips": 1,
                             "why": "x"})
    for m in man["end_to_end"]:
        if m["name"] == "long_reads_per_s":
            m["workloads"].append("chr21_clean_once")
    man["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "long_reads_per_s",
                             "workloads": ["chr21_clean_once"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    spec = run.load_cell("chr21_clean_once", root=str(root))
    assert spec["config"]["profile"]["sub"] == 0.005
    assert spec["traffic"]["pool_calls"] == 2
    assert [m["name"] for m in spec["per_layer"]] == ["calls_per_s"]
    assert "long_reads_per_s" in [m["name"] for m in spec["end_to_end"]]
    read = run.reader("calls_per_s", root=str(root))
    assert read({"calls": 6, "span_s": 2.0}) == 3.0
    assert run.entry_class(spec["traffic"]["entry"]).counts == "long_reads"
    # the cells already there keep their own metrics
    old = run.load_cell("chr21_ont_deep", root=str(root))
    assert "calls_per_s" not in [m["name"] for m in old["per_layer"]]
