"""Audio seconds of the requests completed in the window, per second of the
window."""

from gpubench import readers


def read(ctx):
    return readers.rtfx(ctx)
