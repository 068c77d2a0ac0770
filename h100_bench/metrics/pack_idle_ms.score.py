"""Idle device ms a traced protein spent with the port's packing stages
innermost on its thread: ``esme.model.prepare`` (the padded route's
repack) and ``esme.model.unpad`` (its scatter back, with the pad row's
head)."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.PACK)
