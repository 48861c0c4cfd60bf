"""Seconds of the program's `lr2rmats.sr.seed` spans over the traced
window: `_place_batched`'s seeds, hits, dedupe and validity filter, both
mates; in microseconds a thousand short reads."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.sr.seed", "short_reads", 1e9)
