"""Device ms a sampler step spends in the VideoUNet's temporal halves (spans
``cd360.unet.time_res`` and ``cd360.unet.time_attn``, each with its
blend), from the span fold; None where the program has no such span."""
from harness import spans

NAMES = ("cd360.unet.time_res", "cd360.unet.time_attn")


def read(ctx):
    fold = spans.of(ctx)
    ms = sum(fold.spans[n].device_ms for n in NAMES if n in fold.spans)
    if fold.busy_ms <= 0.0 or not fold.steps or ms <= 0.0:
        return None
    return ms / len(fold.steps)
