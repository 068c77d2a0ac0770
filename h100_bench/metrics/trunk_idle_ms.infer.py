"""Idle device ms a traced forward spent with the trunk innermost on its
thread: ``esme.model.trunk`` (embedding, layers, final norm) and
``esme.model.layer_params`` (the per-layer slices)."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.TRUNK)
