"""The model step's FLOPs in the traced window over its wall, against the
bf16 peak (%)."""

from gpubench import readers


def read(ctx):
    return readers.mfu(ctx, "dispatch")
