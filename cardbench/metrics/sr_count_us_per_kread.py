"""Seconds of the program's `lr2rmats.sr.count` spans over the traced
window: `count_pairs_batched`'s tie selection and count scatters; in
microseconds a thousand short reads."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.sr.count", "short_reads", 1e9)
