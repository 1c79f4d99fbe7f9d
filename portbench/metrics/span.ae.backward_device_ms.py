"""Device ms a step of the autoencoder's gradients (span
``cd360.ae.backward``), from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).per_unit("cd360.ae.backward", "device_ms")
