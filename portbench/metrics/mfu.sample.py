"""Model operations of an image (counted on the reference) over the untraced
image time at the bf16 peak, %."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
