"""Run one cell of the port's benchmark on the card.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell is an entry of `workloads` in
BENCHMARK.json; it names a configuration (its file in `configs`) and a
traffic mix (`cardbench/traffic/<mix>.json`), whose `entry` names the
entry kind (`cardbench/entries/<kind>.py`).  The numbers that decide
`correct` and their limits are in `cardbench/limits/<cell>.json`; each
metric is read by `cardbench/metrics/<metric>.py`.  Nothing here names a
cell, a mix, a configuration or a metric.

A run: load the cell's files; generate the input pool from --seed; build
the program's aligner or counter and warm it up (the entry's `setup`);
drive the timed entry back to back until --seconds have passed, finishing
and counting every call that started inside the window; read the peak
resident set and the card's peak memory; free the program's state; run the
plain reference that decides `correct`; print the numbers compared, each
beside its limit, as the last lines of standard error, and one JSON line as
the last line of standard output.  With --trace 0 the line carries the
cell's end-to-end metrics; with --trace 1 the window runs under
torch.profiler (CUDA activity) and the program's kernel event timers
(`ops/_build.py` `timing`), and the line carries the cell's per-layer
metrics, the device's busy and window seconds and a breakdown.

Exit codes: 0 with a result line; 2 without a card, or with fewer cards
than the cell asks for; 3 when a JAX module was loaded.  No result line is
printed in either case.  The kernel library builds into the checkout's
`build/lr2rmats_tpu_torch/` (the program's fixed directory), and the
compiler caches torch could use (its jiterator's kernel cache, Triton's,
extensions', the CUDA driver's) go under `build/cardbench/`.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "lr2rmats_tpu")


def _pin_caches() -> None:
    cache = os.path.join(ROOT, "build", "cardbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, os.path.join(cache, sub))


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """Everything a run of cell `name` reads: the manifest's entries for
    the cell, its configuration, traffic mix and limits, and the metrics it
    reports (end-to-end and per-layer)."""
    man = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    here = os.path.join(root, "cardbench")

    def reported(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in man["end_to_end"] if reported(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"chips": int(cell["chips"]),
            "config": load_json(os.path.join(root, conf["file"])),
            "traffic": load_json(os.path.join(here, "traffic",
                                              cell["traffic"] + ".json")),
            "limits": load_json(os.path.join(here, "limits",
                                             name + ".json")),
            "end_to_end": e2e, "per_layer": layer}


def reader(metric: str, root: str = ROOT):
    """The `read(record)` function of cardbench/metrics/<metric>.py."""
    path = os.path.join(root, "cardbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_class(kind: str):
    return importlib.import_module(f"cardbench.entries.{kind}").Entry


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT) -> dict:
    """One run of a loaded cell (load_cell) on `device`; returns the
    result line's object (the `checks` key last)."""
    import torch

    from lr2rmats_tpu_torch.ops import _build

    from . import trace as tr
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    entry = entry_class(spec["traffic"]["entry"])(
        spec["config"], spec["traffic"], seed, dev)
    entry.setup()
    rec = {"entry": spec["traffic"]["entry"], "setup_s": process_age_s()}
    prof = tr.profiler(cuda) if trace else None
    n = items = 0
    with tr.maybe(prof), (_build.timing() if trace and cuda
                          else tr.maybe(None)) as kernel_ms:
        with torch.profiler.record_function("cardbench.window"):
            t0 = t = time.perf_counter()
            call_s = []
            while True:
                items += entry.call(n)
                n += 1
                now = time.perf_counter()
                call_s.append(now - t)
                t = now
                if t - t0 >= seconds:
                    break
            span = t - t0
    rec.update({entry.counts: items, "span_s": span, "calls": n,
                "peak_rss_bytes": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024})
    device_line = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if cuda else 0)}
    breakdown = None
    if trace:
        rec.update(entry.layer_record())
        rec["kernel_ms"] = dict(kernel_ms or {})
        if prof is not None:
            busy, window, breakdown = tr.read_trace(prof)
            rec.update(busy_s=busy, window_s=window)
            device_line.update(busy_s=busy, window_s=window)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    entry.finish()
    t = time.perf_counter()
    nums, detail = entry.judge(spec["limits"])
    detail["judge_s"] = time.perf_counter() - t
    out = {"correct": correct(nums),
           "attempted": n, "failed": 0, "metrics": metrics,
           "device": device_line}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["detail"] = {**detail, "calls": n, "span_s": span, "items": items,
                     "call_s": call_s}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in nums}
    return out


def correct(nums) -> bool:
    """A run is correct when no number passes its limit."""
    return all(v <= lim for _, v, lim in nums)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    spec = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"cardbench: the cell needs {spec['chips']} card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
