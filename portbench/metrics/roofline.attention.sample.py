"""The attention kernels' share of their roofline in the traced image: the
least time of the launches the wrappers counted, over the kernels' device
time, %."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, *readers.ATTENTION)
