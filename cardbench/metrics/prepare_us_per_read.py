"""Seconds of the program's `lr2rmats.align.prepare` spans over the traced
window: the chain dispatch's host side (`_prepare_dispatch`: routing,
the native small-row chain, packing) on the seed worker, a lane time; in
microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.align.prepare", "long_reads", 1e6)
