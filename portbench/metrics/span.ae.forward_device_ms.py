"""Device ms a step of the autoencoder's loss (span ``cd360.ae.forward``),
from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).per_unit("cd360.ae.forward", "device_ms")
