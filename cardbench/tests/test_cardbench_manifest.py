"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units and limits, and every cell, mix, configuration and metric has its
files."""

import json
import os
import re

import pytest

from cardbench import run

MAN = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and not \
        re.search(r"[\n\t]", s)


def test_top_level():
    assert set(MAN) == KEYS
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(MAN["command"]) <= 32 and all(map(_line, MAN["command"]))
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")


@pytest.mark.parametrize("section", list(ENTRY_KEYS))
def test_entries(section):
    entries = MAN[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert _line(e[key])


def test_cells_and_metrics():
    cells = {w["name"]: w for w in MAN["workloads"]}
    confs = {c["name"] for c in MAN["configs"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert {tuple(sorted((w["config"], w["traffic"])))
            for w in cells.values()}.__len__() == len(cells)
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for name, w in cells.items():
        assert w["chips"] in (1, 4) and w["config"] in confs
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        spec = run.load_cell(name)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in names
    for c in MAN["configs"]:
        assert c["file"].startswith(MAN["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = run.load_json(os.path.join(run.ROOT, c["file"]))
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert os.path.exists(os.path.join(
            run.ROOT, "cardbench", "metrics", m["name"] + ".py"))


def test_files_are_named_from_names():
    root = os.path.join(run.ROOT, "cardbench")
    for dirpath, _, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), run.ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
