"""The 95th percentile, over every protein scored in the window, of the
wall time from the call of ``predict_mask_margin`` to its scores."""

from hbench import readers


def read(rec):
    return readers.latency_ms(rec, 95)
