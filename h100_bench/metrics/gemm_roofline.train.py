"""The traced steps' matrix-product operations on real tokens (forward,
backward, the recompute's forward again) over the device time of the GEMM
kernels, against 989 TFLOP/s, in percent."""

from hbench import readers


def read(rec):
    return readers.gemm_roofline(rec)
