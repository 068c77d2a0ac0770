"""Idle device ms a traced forward spent with the port's packing stages
innermost on its thread: ``esme.model.prepare`` (uploads, packing meta,
pads, RoPE tables) and ``esme.model.unpad``."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.PACK)
