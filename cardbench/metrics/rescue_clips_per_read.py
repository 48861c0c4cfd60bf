"""Soft clips the terminal-exon rescue seeded over the traced window (the
program's counter `lr2rmats.align.rescue_clips`, a leading and a trailing
clip each counted once), a long read: how often the rescue engages."""

from cardbench.program_spans import counter


def read(rec):
    clips = counter("lr2rmats.align.rescue_clips")
    if clips is None or not rec.get("long_reads"):
        return None
    return clips / rec["long_reads"]
