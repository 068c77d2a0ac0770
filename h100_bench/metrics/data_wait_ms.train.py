"""Host ms a step waited on the data layer's ``next()``, mean over the
window."""

from hbench import readers


def read(rec):
    return readers.data_wait_ms(rec)
