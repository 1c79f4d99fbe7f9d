"""Mean device ms of what a sampler step that holds no render launches
(span ``cd360.sample.step``), from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).step_mean(1)
