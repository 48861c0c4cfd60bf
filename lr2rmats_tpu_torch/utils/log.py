"""Timestamped stage logging, timers, and the program's spans and counters.

Mirrors the observability role of the reference's err_func_format_printf
(reference utils.c:362-390: "=== MM-DD-YYYY HH:MM:SS === [func] msg") and the
realtime/cputime helpers (utils.c:339-351), with a structured, greppable
format.

`span(name, ...)` marks one layer boundary (a call, a phase of a batch,
a wait) and `count(name, n)` counts the work done there.  Tracing is on
while a torch profiler records or a `tracing()` block is open; otherwise a
span makes one flag check and, when given an owner and a key, adds its
seconds to the owner's `stats` (`owner._add_stats`), and `count` does
nothing.  With tracing on, a span also opens
`torch.profiler.record_function(name)`, so spans of the main thread land
in the profiler's trace on the device activity's clock, and it keeps a
record (name, start, end, thread, parent span, call id) in memory;
`span_totals`, `counter_totals` and `span_records` read them and
`reset_spans` clears them.  Nothing is written to a file: the profiler's
own trace export is the exporter.  A span opened with no span around it
on its thread starts a call: its id is the call id of the spans under
it.  A span on a worker thread takes the call id its caller read with
`current_call()`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time


_LOG_STREAM = None  # None => resolve sys.stderr at call time


def set_log_stream(stream) -> None:
    """Set an extra/replacement log stream; None restores dynamic stderr."""
    global _LOG_STREAM
    _LOG_STREAM = stream


def log(func: str, msg: str, *args) -> None:
    """Timestamped stderr logging at phase boundaries."""
    if args:
        msg = msg % args
    ts = time.strftime("%m-%d-%Y %H:%M:%S")
    stream = _LOG_STREAM if _LOG_STREAM is not None else sys.stderr
    try:
        print(f"=== {ts} === [{func}] {msg}", file=stream, flush=True)
    except ValueError:  # closed stream (e.g. a finished pytest capture)
        pass


class Timer:
    """Wall/CPU/RSS timer for a pipeline stage; logs on exit and optionally
    writes a Snakemake-style benchmark file (reference Snakefile `benchmark:`
    directives, e.g. Snakefile:15-16; README.md:131).

    Usage:  with Timer("align", benchmark_file="benchmark/align.benchmark.txt"): ...
    """

    def __init__(self, name: str, quiet: bool = False,
                 benchmark_file: str = None):
        self.name = name
        self.quiet = quiet
        self.benchmark_file = benchmark_file
        self.wall = 0.0
        self.cpu = 0.0
        self.max_rss_mb = 0.0

    def __enter__(self):
        self._w0 = time.perf_counter()
        self._c0 = time.process_time()
        return self

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self._w0
        self.cpu = time.process_time() - self._c0
        try:
            import resource
            self.max_rss_mb = (
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0)
        except Exception:
            pass
        if not self.quiet:
            log(self.name, "done in %.3fs wall / %.3fs cpu", self.wall, self.cpu)
        if self.benchmark_file:
            try:
                os.makedirs(os.path.dirname(self.benchmark_file) or ".",
                            exist_ok=True)
                with open(self.benchmark_file, "w") as f:
                    f.write("s\tcpu_s\tmax_rss_mb\n")
                    f.write(f"{self.wall:.4f}\t{self.cpu:.4f}\t"
                            f"{self.max_rss_mb:.1f}\n")
            except OSError:
                pass
        return False


# ---------------------------------------------------------------- spans
class _Registry:
    """The process's span records and counters (kept while tracing)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = []       # (id, name, start, end, thread, parent, call)
        self.counters = {}
        self.depth = 0          # tracing() blocks open
        self.ids = itertools.count(1)


_REG = _Registry()
_LOCAL = threading.local()      # .stack: [(span id, call id)] of open spans
_PROFILER = None                # torch.autograd.profiler, once imported


def tracing_on() -> bool:
    """True while a torch profiler records or a `tracing()` block is open.
    The profiler's flag is process-wide, so worker threads see it too."""
    global _PROFILER
    if _REG.depth:
        return True
    ap = _PROFILER
    if ap is None:
        # torch not imported yet: no profiler can be recording
        ap = _PROFILER = sys.modules.get("torch.autograd.profiler")
        if ap is None:
            return False
    return ap._is_profiler_enabled


@contextlib.contextmanager
def tracing():
    """Turn tracing on for the block without a profiler (tests, operators)."""
    with _REG.lock:
        _REG.depth += 1
    try:
        yield
    finally:
        with _REG.lock:
            _REG.depth -= 1


def current_call():
    """The call id of the innermost traced span open on this thread, or
    None; pass it as `call=` to spans a worker opens for this call."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1][1] if stack else None


class span:
    """One layer boundary; see the module docstring.

    owner, key: add the span's seconds to `owner`'s stats[key] (through
    `owner._add_stats`), traced or not.  call: the call id of a span a
    worker thread opens for its caller's call."""

    __slots__ = ("name", "owner", "key", "call", "_t0", "_id", "_rf")

    def __init__(self, name: str, owner=None, key: str = None, call=None):
        self.name, self.owner, self.key, self.call = name, owner, key, call
        self._id = 0

    def __enter__(self):
        if tracing_on():
            self._open()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.owner is not None:
            self.owner._add_stats(**{self.key: t1 - self._t0})
        if self._id:
            self._close(t1)
        return False

    def _open(self) -> None:
        import torch
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self._id = next(_REG.ids)
        if stack:
            self.call = stack[-1][1]
        elif self.call is None:
            self.call = self._id
        stack.append((self._id, self.call))
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()

    def _close(self, t1: float) -> None:
        self._rf.__exit__(None, None, None)
        stack = _LOCAL.stack
        stack.pop()
        parent = stack[-1][0] if stack else None
        with _REG.lock:
            _REG.records.append((self._id, self.name, self._t0, t1,
                                 threading.get_ident(), parent, self.call))


def count(name: str, n=1) -> None:
    """Add `n` to the process-wide counter `name`, while tracing is on."""
    if tracing_on():
        with _REG.lock:
            _REG.counters[name] = _REG.counters.get(name, 0) + n


def span_records() -> list:
    """Every span closed while tracing, in the order they closed: dicts of
    id, name, start, end (perf_counter seconds), thread, parent (the id of
    the span open around it on its thread) and call."""
    with _REG.lock:
        recs = list(_REG.records)
    keys = ("id", "name", "start", "end", "thread", "parent", "call")
    return [dict(zip(keys, r)) for r in recs]


def span_totals() -> dict:
    """{name: (seconds, spans)} over the records; a span's self time is its
    seconds less those of its children (span_records' `parent`)."""
    out = {}
    with _REG.lock:
        recs = list(_REG.records)
    for _, name, t0, t1, *_ in recs:
        s, n = out.get(name, (0.0, 0))
        out[name] = (s + t1 - t0, n + 1)
    return out


def counter_totals() -> dict:
    """{name: total} of the counters."""
    with _REG.lock:
        return dict(_REG.counters)


def reset_spans() -> None:
    """Forget every span record and counter."""
    with _REG.lock:
        _REG.records.clear()
        _REG.counters.clear()
