"""Mean device ms of a sampler step of the clip (span
``cd360.sample.step``: one guided VideoUNet evaluation of both copies and
its Euler update), from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).step_mean(1)
