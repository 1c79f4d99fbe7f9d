"""Mean span of the sampler's cached steps 1-49 (the render's features reused),
synchronised by the sampler's callback, ms."""
from harness import readers


def read(ctx):
    return readers.span(ctx, "cached_step_ms")
