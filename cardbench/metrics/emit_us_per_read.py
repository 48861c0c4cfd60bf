"""The harness's host clock around `RecordBatch.emit_sam` over the window,
in microseconds a long read."""


def read(rec):
    if "emit_s" not in rec:
        return None
    return 1e6 * rec["emit_s"] / rec["long_reads"]
