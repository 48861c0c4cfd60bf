"""Polish's useful outcomes over its attempts in the traced window: the
program's counters `lr2rmats.polish.replaced` (junctions re-placed) over
`lr2rmats.polish.tried` (junction placements tried)."""

from cardbench.program_spans import counter


def read(rec):
    tried = counter("lr2rmats.polish.tried")
    if not tried or "long_reads" not in rec:
        return None
    return (counter("lr2rmats.polish.replaced") or 0) / tried
