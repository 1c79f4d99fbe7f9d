"""The bilinear sampling wrappers' share of their roofline in the fold's
steps, forward and backward, over the device time of the spans
``cd360.op.bilinear`` and ``cd360.op.bilinear_bwd``, %."""
from harness import readers, spans


def read(ctx):
    return spans.roofline(ctx, readers.BILINEAR[0], ["cd360.op.bilinear", "cd360.op.bilinear_bwd"])
