"""``torch.cuda.max_memory_allocated()`` over the window, its count reset
at the window's start, in GiB."""

from hbench import readers


def read(rec):
    return readers.peak_mem_gib(rec)
