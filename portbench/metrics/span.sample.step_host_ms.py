"""Mean host ms of a sampler step (span ``cd360.sample.step``) that holds no
render, from the span fold: no synchronisation between steps."""
from harness import spans


def read(ctx):
    return spans.of(ctx).step_mean(0)
