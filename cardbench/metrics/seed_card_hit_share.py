"""The share of the window's lookup hits that were expanded, sorted,
grouped and selected on the card (the program's counter
`lr2rmats.align.hits_card`) of all of them (`lr2rmats.align.hits`); the
rest belong to reads whose hits overflow the card's sort and take the
host path.  A program without the card selection records no `hits_card`
and the metric is left out."""

from cardbench.program_spans import counter


def read(rec):
    hits = counter("lr2rmats.align.hits")
    card = counter("lr2rmats.align.hits_card")
    if not hits or card is None or "long_reads" not in rec:
        return None
    return card / hits
