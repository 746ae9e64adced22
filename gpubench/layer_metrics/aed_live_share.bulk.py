"""The AED decode loop's live steps (%): each real lane's tokens and its
EOS, over the steps the loop ran for the real lanes, the port's counters
aed.live_lane_steps_total over aed.lane_steps_total, differenced over the
window."""

from gpubench import readers


def read(ctx):
    r = readers.counter_ratio(ctx, "aed", "live_lane_steps_total",
                              "lane_steps_total")
    return None if r is None else r * 100
