"""Share of the traced steps' span in which no device operation ran."""

from hbench import readers


def read(rec):
    return readers.idle_pct(rec)
