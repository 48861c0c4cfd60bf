"""Seconds of the program's `lr2rmats.align.build_wait` spans over the
traced window: the main thread blocked on the build workers' results; in
microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.align.build_wait", "long_reads", 1e6)
