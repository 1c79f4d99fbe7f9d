"""The GroupNorm kernels' share of their roofline in the traced steps, %."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, *readers.GROUP_NORM)
