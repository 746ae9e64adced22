"""Tokens delivered per device dispatch (runtime/batcher.py): the port's
tokens_total over dispatches, differenced over the window."""

from gpubench import readers


def read(ctx):
    if "tokens_total" not in ctx["counters"]["start"].get("batcher", {}):
        return None  # a port without the counter
    return readers.counter_ratio(ctx, "batcher", "tokens_total",
                                 "dispatches")
