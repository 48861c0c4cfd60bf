"""The program's own spans and counters, for the per-layer metrics that
read them (`lr2rmats_tpu_torch/utils/log.py`: `span_totals`,
`counter_totals`).

The program records them only while tracing is on, which in a run is the
`--trace 1` window under torch.profiler: the totals cover the window's
calls and nothing of set-up.  A program that has no such span or counter
(a checkout older than them) gives None, and the reader leaves its metric
out.
"""


def span_seconds(name: str):
    """Seconds of every span `name` recorded, or None."""
    try:
        from lr2rmats_tpu_torch.utils.log import span_totals
    except ImportError:
        return None
    total = span_totals().get(name)
    return None if total is None else total[0]


def counter(name: str):
    """The total of counter `name`, or None."""
    try:
        from lr2rmats_tpu_torch.utils.log import counter_totals
    except ImportError:
        return None
    return counter_totals().get(name)


def per_item(rec: dict, name: str, items: str, scale: float):
    """`scale` x the seconds of span `name` over the record's `items`
    (long_reads or short_reads), or None."""
    s = span_seconds(name)
    if s is None or not rec.get(items):
        return None
    return scale * s / rec[items]
