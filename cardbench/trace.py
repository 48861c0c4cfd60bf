"""The traced window: torch.profiler over it, and what its trace says.

`read_trace` exports the profiler's trace (Chrome trace format) to a
temporary file under TMPDIR, reads it and deletes it.  From the device
activities (kernels, copies and sets) inside the `cardbench.window` span it
takes the device's busy seconds (the union of their intervals), the
window's seconds, the ten device operations that took most time, and the
ten longest idle gaps, each named by the innermost `cardbench.*` span of
the harness that was open on the host at the gap's middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "cardbench.window"


def profiler(cuda: bool):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def maybe(ctx):
    return ctx if ctx is not None else contextlib.nullcontext()


def union(intervals):
    """Sorted disjoint [start, end) intervals covering `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events):
    """(busy_s, window_s, breakdown) of a list of Chrome trace events."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("cardbench.")]
    win = [(s, e) for s, e, n in spans if n == WINDOW]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} span")
    w0, w1 = win[0]
    dev = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1), e["name"])
           for e in events if e.get("cat") in DEVICE_CATS and "ts" in e]
    dev = [d for d in dev if d[1] > d[0]]
    busy = union([(s, e) for s, e, _ in dev])
    by_name = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e6
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    inner = [x for x in spans if x[2] != WINDOW]

    def name_of(a, b):
        mid = (a + b) / 2
        cover = [x for x in inner if x[0] <= mid <= x[1]]
        return min(cover, key=lambda x: x[1] - x[0])[2] if cover else WINDOW

    gaps.sort(key=lambda g: g[0] - g[1])
    breakdown = {
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[name_of(a, b), (b - a) / 1e6] for a, b in gaps[:10]]}
    return (sum(e - s for s, e in busy) / 1e6, (w1 - w0) / 1e6, breakdown)


def read_trace(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events)
