"""The device's idle share of the traced window (%)."""

from gpubench import readers


def read(ctx):
    return readers.idle_share(ctx)
