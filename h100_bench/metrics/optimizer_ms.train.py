"""Device ms a traced step spent in kernels launched under the optimizer's
``Optimizer.step`` record."""

from hbench import readers


def read(rec):
    return readers.optimizer_ms(rec)
