"""Idle device ms a traced step spent inside ``esme.train.backward`` (the
backward and its checkpoint recompute, wherever autograd launches from)."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.BACKWARD)
