"""Model operations of a step (both sub-steps' forwards and backwards, counted
on the reference) over the untraced step time at the bf16 peak, %."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
