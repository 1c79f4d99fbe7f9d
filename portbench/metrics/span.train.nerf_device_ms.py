"""Device ms a step of what the NeRF's per-chunk encoding launches (span
``cd360.nerf``: the forward and, under checkpoint, its recompute), from the
span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).per_unit("cd360.nerf", "device_ms")
