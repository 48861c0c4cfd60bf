"""Seconds of the program's `lr2rmats.align.rescue` spans over the traced
window: the terminal-exon rescue pass inside the build span, on the build
workers; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.align.rescue", "long_reads", 1e6)
