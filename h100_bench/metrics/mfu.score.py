"""The window's model operations on the masked copies' real tokens
(2·N·tokens + the attention forward's) over its wall time, against 989
TFLOP/s, in percent."""

from hbench import readers


def read(rec):
    return readers.mfu(rec)
