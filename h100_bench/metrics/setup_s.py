"""Seconds from the process's start to the window's: imports, the card,
the kernels' build, weights, inputs and warm-up."""

from hbench import readers


def read(rec):
    return readers.setup_s(rec)
