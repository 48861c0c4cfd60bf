"""Each metric reader on recorded records, and the trace reduction on a
recorded trace."""

import json
import os

import pytest

from cardbench import run, trace

ALIGN = {"entry": "align", "setup_s": 31.5, "long_reads": 24576,
         "span_s": 10.24, "calls": 4, "peak_rss_bytes": 3 * 2**30,
         "align_stats": {"seed_s": 2.4576, "dispatch_s": 0.24576,
                         "build_s": 4.9152, "polish_s": 7.3728,
                         "device_wall_s": 0.1},
         "emit_s": 0.49152,
         "kernel_ms": {"chain_dp_backtrack": 20.0, "shift_dp": 4.0},
         "busy_s": 0.1024, "window_s": 10.24}
SR = {"entry": "sr_count", "setup_s": 25.0, "short_reads": 2_000_000,
      "span_s": 10.0, "calls": 5, "peak_rss_bytes": 2**31,
      "kernel_ms": {"hamming": 10.0}, "busy_s": 0.5, "window_s": 10.0}
WANT = {
    "long_reads_per_s": (2400.0, None), "short_reads_per_s": (None, 2e5),
    "peak_rss_gib": (3.0, 2.0), "setup_s": (31.5, 25.0),
    "seed_us_per_read": (100.0, None), "dispatch_us_per_read": (10.0, None),
    "build_us_per_read": (200.0, None), "polish_us_per_read": (300.0, None),
    "emit_us_per_read": (20.0, None),
    "chain_kernel_us_per_read": (1e3 * 20.0 / 24576, None),
    "shift_dp_kernel_us_per_read": (1e3 * 4.0 / 24576, None),
    "device_idle_share.align": (0.99, None),
    "hamming_kernel_us_per_kread": (None, 5.0),
    "device_idle_share.sr": (None, 0.95)}


def test_every_metric_has_a_case():
    man = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    assert {m["name"] for m in man["end_to_end"] + man["per_layer"]} == \
        set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    read = run.reader(name)
    for rec, want in zip((ALIGN, SR), WANT[name]):
        got = read(dict(rec))
        if want is None:
            assert got is None
        else:
            assert got == pytest.approx(want)


def test_reader_finds_nothing():
    rec = {k: v for k, v in ALIGN.items() if k != "kernel_ms"}
    assert run.reader("chain_kernel_us_per_read")(rec) is None
    assert run.reader("polish_us_per_read")(
        {**ALIGN, "align_stats": {}}) is None


def test_reduce_events():
    ev = [
        {"cat": "user_annotation", "name": "cardbench.window", "ts": 1000,
         "dur": 10000},
        {"cat": "user_annotation", "name": "cardbench.align_seqset_packed",
         "ts": 1000, "dur": 6000},
        {"cat": "user_annotation", "name": "cardbench.emit_sam",
         "ts": 7000, "dur": 4000},
        {"cat": "cpu_op", "name": "aten::add", "ts": 1500, "dur": 10},
        {"cat": "kernel", "name": "chain", "ts": 2000, "dur": 500},
        {"cat": "kernel", "name": "chain", "ts": 2400, "dur": 300},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 5000, "dur": 100},
        {"cat": "kernel", "name": "early", "ts": 0, "dur": 1500},
    ]
    busy, window, bd = trace.reduce_events(ev)
    # [1000, 1500) + [2000, 2700) + [5000, 5100)
    assert busy == pytest.approx(1300e-6)
    assert window == pytest.approx(0.01)
    assert bd["device_ops"][0] == ["chain", pytest.approx(800e-6)]
    assert bd["idle_gaps"][0] == ["cardbench.emit_sam",
                                  pytest.approx(5900e-6)]
    assert bd["idle_gaps"][1] == ["cardbench.align_seqset_packed",
                                  pytest.approx(2300e-6)]
    assert len(bd["idle_gaps"]) == 3
