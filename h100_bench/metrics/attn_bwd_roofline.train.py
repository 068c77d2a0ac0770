"""H2's least time for the traced steps' attention backward over its
device time, in percent."""

from hbench import readers


def read(rec):
    return readers.attn_bwd_roofline(rec)
