"""The window's model operations (2·N·real tokens + the attention
forward's) over its wall time, against 989 TFLOP/s, in percent."""

from hbench import readers


def read(rec):
    return readers.mfu(rec)
