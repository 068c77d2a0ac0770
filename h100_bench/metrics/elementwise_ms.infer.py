"""Device ms a traced forward spent in kernels that are neither GEMMs nor
the port's own."""

from hbench import readers


def read(rec):
    return readers.elementwise_ms(rec)
