"""The process's peak resident set (ru_maxrss), in GiB, read after the
window and before the reference runs."""


def read(rec):
    return rec["peak_rss_bytes"] / 2**30
