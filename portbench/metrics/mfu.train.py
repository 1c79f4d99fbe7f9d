"""Model operations of a step (forward and the backward the trainable set
needs, counted on the reference) over the untraced step time at the bf16
peak, %."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
