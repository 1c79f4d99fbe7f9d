"""Span of the conditioner call (prompt and negative prompt, both towers),
synchronised, ms an image."""
from harness import readers


def read(ctx):
    return readers.span(ctx, "conditioner_ms")
