"""The GroupNorm wrapper's share of its roofline in the fold's steps, over
the device time of the span ``cd360.op.group_norm``, %."""
from harness import readers, spans


def read(ctx):
    return spans.roofline(ctx, readers.GROUP_NORM[0], ["cd360.op.group_norm"])
