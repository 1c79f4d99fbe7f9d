"""Device ms an image of what ``Engine.sample`` launches inside the span
``cd360.sample.prepare`` (the per-call q/k/v fusion and the reference
features), from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).per_unit("cd360.sample.prepare", "device_ms")
