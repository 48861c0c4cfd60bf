"""Seconds of the program's `lr2rmats.polish.place` spans over the traced
window: polish's placement: the copies to the card, `polish_best_pair`
and the copy back; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.polish.place", "long_reads", 1e6)
