"""The aligner's `stats["polish_s"]` over the window (summed over its
worker threads: the lane's busy time, not a share of the wall), in
microseconds a long read."""


def read(rec):
    st = rec.get("align_stats") or {}
    if "polish_s" not in st:
        return None
    return 1e6 * st["polish_s"] / rec["long_reads"]
