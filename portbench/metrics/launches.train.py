"""Device operations (kernels, copies) a step, from the trace."""
from harness import readers


def read(ctx):
    return readers.launches(ctx)
