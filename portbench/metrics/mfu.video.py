"""Model operations of a clip (counted on the reference: the conditioner,
every step's UNet over both guider copies, the decode) over the untraced
clip time at the bf16 peak, %."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
