"""The aligner's `stats["seed_s"]` over the window (summed over its
worker threads: the lane's busy time, not a share of the wall), in
microseconds a long read."""


def read(rec):
    st = rec.get("align_stats") or {}
    if "seed_s" not in st:
        return None
    return 1e6 * st["seed_s"] / rec["long_reads"]
