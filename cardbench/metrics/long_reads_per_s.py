"""Long reads aligned per second: every read of every call of the window,
over the time from the window's start to the end of its last call."""


def read(rec):
    if "long_reads" not in rec:
        return None
    return rec["long_reads"] / rec["span_s"]
