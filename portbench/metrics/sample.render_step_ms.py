"""Span of the sampler's step 0 (the pose blocks' render), synchronised by the
sampler's callback, ms."""
from harness import readers


def read(ctx):
    return readers.span(ctx, "render_step_ms")
