"""The window's model operations (6·N·real tokens + 3.5× the attention
forward's; the recompute not counted) over its wall time, against 989
TFLOP/s, in percent."""

from hbench import readers


def read(rec):
    return readers.mfu(rec)
