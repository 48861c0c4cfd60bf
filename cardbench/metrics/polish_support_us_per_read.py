"""Seconds of the program's `lr2rmats.polish.support` spans over the traced
window: polish's junction table, support, consensus winners and holders
index; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.polish.support", "long_reads", 1e6)
