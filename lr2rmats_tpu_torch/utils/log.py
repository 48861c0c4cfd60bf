"""Timestamped stage logging + timers.

Mirrors the observability role of the reference's err_func_format_printf
(reference utils.c:362-390: "=== MM-DD-YYYY HH:MM:SS === [func] msg") and the
realtime/cputime helpers (utils.c:339-351), with a structured, greppable
format.
"""

from __future__ import annotations

import os
import sys
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
