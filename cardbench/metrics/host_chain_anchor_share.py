"""The share of the window's chain-row anchors that chain on the host
because their row exceeds the card's routing (over A_BUCKETS[-1]
anchors, over EXC_ROWS large deltas, or a query position past 2^16):
the program's counters `lr2rmats.align.anchors_host` over
`lr2rmats.align.anchors`."""

from cardbench.program_spans import counter


def read(rec):
    anchors = counter("lr2rmats.align.anchors")
    if not anchors or "long_reads" not in rec:
        return None
    return (counter("lr2rmats.align.anchors_host") or 0) / anchors
