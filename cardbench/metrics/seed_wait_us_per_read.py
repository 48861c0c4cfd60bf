"""Seconds of the program's `lr2rmats.align.seed_wait` spans over the
traced window: the main thread blocked on the seed worker's next batch;
in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.align.seed_wait", "long_reads", 1e6)
