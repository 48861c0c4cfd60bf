"""Seconds of the program's `lr2rmats.polish.windows` spans over the traced
window: polish's per-record windows and the packing of the placement
tasks; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.polish.windows", "long_reads", 1e6)
