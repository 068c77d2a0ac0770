"""H1's least time for the traced forwards' attention (bytes at 3.35 TB/s
or operations at 989 TFLOP/s, the larger) over its device time, in percent."""

from hbench import readers


def read(rec):
    return readers.attn_fwd_roofline(rec)
