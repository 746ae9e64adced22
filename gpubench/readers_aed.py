"""What the AED family's per-layer readers compute from the port's ``aed``
counters (``/metrics``, differenced over the window) and the benchmark's
dispatch records (``sut.Spans``, traced runs). A port without the ``aed``
group gives None, and the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from . import roofline_aed as ra


def _delta(ctx, key: str) -> Optional[float]:
    a, b = ctx["counters"]["start"], ctx["counters"]["end"]
    if "aed" not in a or "aed" not in b:
        return None
    return b["aed"][key] - a["aed"][key]


def device_ms(ctx, key: str) -> Optional[float]:
    """A stage's device time a dispatch (ms), from the counter ``key``:
    None where the port has no such counter, ran no dispatch, or timed
    none on a card (a run on the CPU)."""
    n, secs = _delta(ctx, "dispatches"), _delta(ctx, key)
    return secs / n * 1e3 if n and secs else None


def max_len(ctx) -> Optional[int]:
    """The loop's decisions a dispatch: steps over dispatches."""
    n, steps = _delta(ctx, "dispatches"), _delta(ctx, "steps_total")
    return int(round(steps / n)) if n else None


def window_dispatches(ctx):
    """(the dispatch records that ended in the window, the loop's steps a
    dispatch, the decode stage's device seconds over the window), or None
    where the port or the run has none of them."""
    sp, steps = ctx.get("spans"), max_len(ctx)
    if sp is None or steps is None:
        return None
    recs = [r for r in sp.dispatches if ctx["t0"] <= r["t1"] < ctx["t1"]]
    return recs, steps, _delta(ctx, "decode_device_s_total")


def mfu(ctx) -> Optional[float]:
    """Model FLOPs of the dispatches in the traced window, prorated by
    their overlap with it (as ``readers.mfu``), over its wall, against the
    bf16 peak (%)."""
    tr, sp, steps = ctx.get("trace"), ctx.get("spans"), max_len(ctx)
    if tr is None or sp is None or steps is None:
        return None
    flops = 0.0
    for rec in sp.dispatches:
        over = min(rec["t1"], tr["p1"]) - max(rec["t0"], tr["p0"])
        if over > 0:
            flops += ra.model_flops(ctx["m"], rec, steps) * over / max(
                rec["t1"] - rec["t0"], 1e-9)
    if not flops:
        return None
    return flops / (tr["p1"] - tr["p0"]) / ra.PEAK_OPS["bf16"] * 100
