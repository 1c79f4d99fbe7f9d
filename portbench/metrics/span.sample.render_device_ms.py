"""Device ms an image of what is launched inside the span
``cd360.sample.render`` (step 0: the pose blocks' render and its Euler
update), from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).per_unit("cd360.sample.render", "device_ms")
