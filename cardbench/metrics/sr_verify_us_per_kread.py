"""Seconds of the program's `lr2rmats.sr.verify` spans over the traced
window: `_place_batched`'s Hamming verify: the buffer layout, the verify
on the card and its copies back, both mates; in microseconds a thousand
short reads."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.sr.verify", "short_reads", 1e9)
