"""Short reads counted per second (two a pair): every read of every batch
of the window, over the time from the window's start to the end of its
last batch."""


def read(rec):
    if "short_reads" not in rec:
        return None
    return rec["short_reads"] / rec["span_s"]
