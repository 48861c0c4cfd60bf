"""Index places the window's lookups returned, before grouping (the
program's counter `lr2rmats.align.hits`, the sum of hi - lo), a long
read: the anchors the seed lane fetches, sorts and groups; on a
saturated index most of them are spurious."""

from cardbench.program_spans import counter


def read(rec):
    hits = counter("lr2rmats.align.hits")
    if hits is None or not rec.get("long_reads"):
        return None
    return hits / rec["long_reads"]
