"""The attention wrappers' share of their roofline in the fold's clip (the
d = 64 kernel over 9216, 2304 and 576 tokens; the decoder's d = 512): the
least time of the launches they counted there, over the device time of the
span ``cd360.op.attention``, %."""
from harness import readers, spans


def read(ctx):
    return spans.roofline(ctx, readers.ATTENTION[0], ["cd360.op.attention"])
