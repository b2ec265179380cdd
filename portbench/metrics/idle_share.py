"""idle_share.<cell kind>: the share of the traced tail in which no
operation ran on the card (1 - busy / window, profiler).  One reader for
the whole family: the harness finds ``metrics/<name>.py``, or else the
file of the name's first part."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
