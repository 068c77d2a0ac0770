"""Idle device ms a traced step spent with the trunk's forward innermost
on its thread (``esme.model.trunk``, ``esme.model.layer_params``)."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.TRUNK)
