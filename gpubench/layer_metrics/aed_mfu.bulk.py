"""The AED model step's FLOPs in the traced window (the encoder over the
real frames and the decode loop's least operations, gpubench/roofline_aed.py)
over its wall, against the bf16 peak (%)."""

from gpubench.readers_aed import mfu


def read(ctx):
    return mfu(ctx)
