"""Share of the traced proteins' span in which no device operation ran."""

from hbench import readers


def read(rec):
    return readers.idle_pct(rec)
