"""H1's least time for the traced steps' attention forwards (both launches
a layer under ``remat='full'``) over its device time, in percent."""

from hbench import readers


def read(rec):
    return readers.attn_fwd_roofline(rec)
