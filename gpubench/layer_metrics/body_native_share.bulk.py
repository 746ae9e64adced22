"""Share of the batch bodies that the port's native decoder took
(server/body.py, csrc/body.cc), of all batch bodies decoded: the batcher
group's body_native_total over body_native_total + body_fallback_total,
differenced over the window (%)."""


def read(ctx):
    start, end = (ctx["counters"][k].get("batcher", {})
                  for k in ("start", "end"))
    if "body_native_total" not in start:
        return None  # a port without the native decoder
    native, fallback = (end[k] - start[k] for k in ("body_native_total",
                                                      "body_fallback_total"))
    total = native + fallback
    return native / total * 100 if total else None
