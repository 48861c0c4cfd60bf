"""Seconds of the program's `lr2rmats.polish.ties` spans over the traced
window: polish's `_resolve_weight_ties`; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.polish.ties", "long_reads", 1e6)
