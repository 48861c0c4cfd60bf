"""Seconds of the program's `lr2rmats.sr.pair` spans over the traced
window: `count_pairs_batched`'s best arrays and mate concordance chunks;
in microseconds a thousand short reads."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.sr.pair", "short_reads", 1e9)
