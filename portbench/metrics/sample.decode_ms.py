"""Span of the VAE decode and the uint8 copy to the host, ms an image."""
from harness import readers


def read(ctx):
    return readers.span(ctx, "decode_ms")
