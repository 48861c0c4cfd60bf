"""Seconds of the program's `lr2rmats.align.chain_wait` spans over the
traced window: the main thread in `_materialize_chains`: the wait on the
card, the copies back and the decode; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.align.chain_wait", "long_reads", 1e6)
