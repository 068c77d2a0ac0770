"""Real tokens (specials in, padding never) of every forward the window
completed, over the window's wall time."""

from hbench import readers


def read(rec):
    return readers.tokens_per_s(rec)
