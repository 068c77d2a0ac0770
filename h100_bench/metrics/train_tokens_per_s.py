"""Real tokens of every masked-LM step the window completed, over the
window's wall time."""

from hbench import readers


def read(rec):
    return readers.tokens_per_s(rec)
