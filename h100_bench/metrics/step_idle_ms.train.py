"""Idle device ms a traced step spent in the trainer's own stages: the
batch upload, the forward outside the trunk (its prepare and head), the
loss, the optimizer and the loss's sync."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.STEP)
