"""The traced forwards' matrix-product operations on real tokens over the
device time of the GEMM kernels, against 989 TFLOP/s, in percent."""

from hbench import readers


def read(rec):
    return readers.gemm_roofline(rec)
