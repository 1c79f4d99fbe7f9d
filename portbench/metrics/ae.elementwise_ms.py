"""Device ms a step outside the port's kernels, the GEMMs, the convolutions and
the copies: the GroupNorm backward's recompute, LPIPS' norms, Adam."""
from harness import readers


def read(ctx):
    return readers.outside_ms(ctx, readers.NAMED_KERNELS, readers.GEMM, readers.CONV, readers.COPY)
