"""csrc/mel.cu's share of its roofline (%) in the traced dispatches."""

from gpubench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "dispatch", "log_mel")
