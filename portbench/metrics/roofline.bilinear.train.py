"""The bilinear sampling kernels' share of their roofline in the traced steps,
forward and backward, %."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, *readers.BILINEAR)
