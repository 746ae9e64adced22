"""Mean wait of a request in the batcher's queue (runtime/batcher.py), from
its enqueue to the start of its device call: the port's
queue_wait_s_total over queued_total, differenced over the window (ms)."""

from gpubench import readers


def read(ctx):
    if "queue_wait_s_total" not in ctx["counters"]["start"].get("batcher",
                                                               {}):
        return None  # a port without the counter
    ratio = readers.counter_ratio(ctx, "batcher", "queue_wait_s_total",
                                  "queued_total")
    return None if ratio is None else ratio * 1e3
