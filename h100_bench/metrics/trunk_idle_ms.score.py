"""Idle device ms a traced protein spent with the trunk innermost on its
thread (``esme.model.trunk``, ``esme.model.layer_params``), over its
chunks of masked copies."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.TRUNK)
