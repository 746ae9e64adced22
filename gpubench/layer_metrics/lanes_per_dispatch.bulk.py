"""Requests per device dispatch (runtime/batcher.py): the batcher's
lanes_total over dispatches, differenced over the window."""

from gpubench import readers


def read(ctx):
    return readers.counter_ratio(ctx, "batcher", "lanes_total", "dispatches")
