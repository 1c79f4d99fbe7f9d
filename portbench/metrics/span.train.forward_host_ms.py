"""Host ms a step of the span ``cd360.train.forward`` (``Engine.training_loss``),
from the span fold."""
from harness import spans


def read(ctx):
    return spans.of(ctx).per_unit("cd360.train.forward", "host_ms")
