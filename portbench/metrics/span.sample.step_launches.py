"""Mean device operations (kernels, copies, sets) launched in a sampler step
that holds no render (span ``cd360.sample.step``), from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).step_mean(2)
