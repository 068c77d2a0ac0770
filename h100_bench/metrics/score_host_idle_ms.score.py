"""Idle device ms a traced protein spent in the scoring loop's own stages:
each chunk's build, its forward outside the model's stages, the fetch of
its rows and the host margins."""

from hbench import stages


def read(rec):
    return stages.idle_ms(rec, stages.SCORE_HOST)
