"""Seconds of the program's `lr2rmats.polish.accept` spans over the traced
window: polish's sequential accept loop: window scores, motif bonuses,
the host DP re-runs and the CIGAR rewrite; in microseconds a long read."""

from cardbench.program_spans import per_item


def read(rec):
    return per_item(rec, "lr2rmats.polish.accept", "long_reads", 1e6)
