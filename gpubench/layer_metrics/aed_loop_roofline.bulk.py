"""The AED decode loop's share of its roofline (%): the least time of the
decode stage (gpubench/roofline_aed.py, from each dispatch's real lanes,
their encoder frames and tokens) of the dispatches that ended in the
window, over the device time the port's counter aed.decode_device_s_total
gave them."""

from gpubench import roofline_aed as ra
from gpubench.readers_aed import window_dispatches


def read(ctx):
    got = window_dispatches(ctx)
    if got is None:
        return None
    recs, max_len, spent = got
    need = 0.0
    for r in recs:
        ops, n_bytes = ra.loop_work(ctx["m"], ra.dispatch_lanes(r), max_len)
        need += ra.bound_s(n_bytes, ops)
    return need / spent * 100 if spent else None
