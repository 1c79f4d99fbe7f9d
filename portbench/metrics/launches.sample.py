"""Device operations (kernels, copies) an image, from the trace."""
from harness import readers


def read(ctx):
    return readers.launches(ctx)
