"""The device seed lookup's share of its bandwidth roofline, in percent:
the bytes the window's lookups need (`lookup_bytes` of the program's
counter `lr2rmats.align.lookup_queries`) over the card's HBM bandwidth,
divided by the CUDA-event time of the lookup's two searches (the
program's `ops/_build.py` `timing()`, kernel name `seed_lookup`).

A lookup of one query needs its 4-byte hash read, its two 4-byte bounds
written and, for each bound, the one 32-byte sector of the table that
brackets the answer: what the answer depends on, whatever the search
reads on the way.  Only real queries count, not the padding.  The peak
is the H100 SXM's published 3.35 TB/s."""

from cardbench.program_spans import counter

HBM_BYTES_PER_S = 3.35e12
SECTOR = 32


def lookup_bytes(queries: int) -> int:
    """Bytes that `queries` lookups need: 4 in, two 4-byte bounds out, one
    table sector for each bound."""
    return queries * (4 + 2 * 4 + 2 * SECTOR)


def read(rec):
    ms = (rec.get("kernel_ms") or {}).get("seed_lookup")
    queries = counter("lr2rmats.align.lookup_queries")
    if not ms or not queries:
        return None
    return 100.0 * lookup_bytes(queries) / HBM_BYTES_PER_S / (ms * 1e-3)
