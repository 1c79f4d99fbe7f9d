"""Share of a clip's untraced time in which the device ran nothing, %."""
from harness import readers


def read(ctx):
    return readers.idle_share(ctx)
