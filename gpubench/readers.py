"""What the metric readers compute. Each metric of ``BENCHMARK.json`` has
a small reader of its own (``gpubench/end_to_end/<name>.py``,
``gpubench/layer_metrics/<name>.py``) with ``read(ctx)``, most of which
call one of these. A reader that finds nothing to read returns None, and
the metric is left out of the run's line.

``ctx`` holds the window (``t0``, ``t1``), the client's ``records``, the
program's counters at the window's edges (``counters``), the benchmark's
``spans`` (traced runs), the device ``trace`` (traced runs on the card)
and the model's widths ``m``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import roofline, trace

# -- end to end (the client's clock) ------------------------------------------


def _in(x: float, ctx) -> bool:
    return ctx["t0"] <= x < ctx["t1"]


def p95(values: List[float]) -> Optional[float]:
    return float(np.percentile(values, 95)) if values else None


def rtfx(ctx) -> Optional[float]:
    """Audio seconds of the requests completed in the window, per second."""
    done = [r["audio_s"] for r in ctx["records"]
            if r.get("status") == 200 and _in(r["done"], ctx)]
    return sum(done) / (ctx["t1"] - ctx["t0"]) if done else None


def requests_ms(ctx) -> List[float]:
    """Every request due in the window: its due time to the whole
    response."""
    return [(r["done"] - r["due"]) * 1e3 for r in ctx["records"]
            if r.get("status") == 200 and _in(r["due"], ctx)]


def finals_ms(ctx) -> List[float]:
    """Every stream whose END was due in the window: END's due time to the
    COMPLETE."""
    return [(r["complete"] - r["end_due"]) * 1e3 for r in ctx["records"]
            if "complete" in r and _in(r["end_due"], ctx)]


def partials_ms(ctx) -> List[float]:
    """Every partial answering a frame due in the window: the frame's due
    time to the partial."""
    return [(t - due) * 1e3 for r in ctx["records"]
            for due, t in r.get("partials", []) if _in(due, ctx)]


# -- counters and spans -------------------------------------------------------


def counter_ratio(ctx, group: str, num: str, den: str) -> Optional[float]:
    a, b = ctx["counters"]["start"], ctx["counters"]["end"]
    if group not in a:
        return None
    dn = b[group][num] - a[group][num]
    dd = b[group][den] - a[group][den]
    return dn / dd if dd else None


def _spans(ctx, kind: str):
    if ctx.get("spans") is None:
        return []
    return [(s, e) for k, s, e in ctx["spans"].spans
            if k == kind and _in(s, ctx)]


def http_host_ms(ctx) -> Optional[float]:
    """The HTTP handler's time outside the batcher, per request: handler
    spans minus the spans of their waits in ``batcher.submit``."""
    http, sub = _spans(ctx, "http"), _spans(ctx, "submit")
    if not http:
        return None
    return (sum(e - s for s, e in http) - sum(e - s for s, e in sub)) \
        * 1e3 / len(http)


def mean_span_ms(ctx, kind: str) -> Optional[float]:
    spans = _spans(ctx, kind)
    return sum(e - s for s, e in spans) * 1e3 / len(spans) if spans \
        else None


# -- the device trace ---------------------------------------------------------


def _records(ctx, kind: str):
    """Dispatch or tick records that lie inside the traced window."""
    tr, sp = ctx.get("trace"), ctx.get("spans")
    if tr is None or sp is None:
        return []
    recs = sp.dispatches if kind == "dispatch" else sp.ticks
    return [r for r in recs if r["t0"] >= tr["p0"] and r["t1"] <= tr["p1"]]


def _work(ctx, rec, kind: str):
    """(emissions, decoded frames, lanes, [(feature frames, encoded frames,
    keys per query)]) of one dispatch or tick."""
    m = ctx["m"]
    if kind == "dispatch":
        lanes = [(roofline.mel_frames(s), e, e)
                 for s, e in zip(rec["samples"], rec["enc"])]
        return sum(rec["tokens"]), sum(rec["enc"]), len(lanes), lanes
    lanes = [(real, enc, roofline.causal_keys(m, pos, enc))
             for real, enc, pos in rec["lanes"]]
    return rec["tokens"], sum(e for _, e, _ in lanes), len(lanes), lanes


def kernel_roofline(ctx, kind: str, kernel: str) -> Optional[float]:
    """Share (%) of the least time over the measured time of ``kernel``
    ("greedy_loop" or "log_mel") in the dispatches or ticks of the traced
    window, each kernel matched to the call it ran in."""
    tr, m = ctx.get("trace"), ctx["m"]
    need = spent = 0.0
    for rec in _records(ctx, kind):
        t = trace.kernel_time_in(tr, kernel, rec["t0"], rec["t1"])
        if t is None:
            continue
        if kernel == "log_mel":
            for s in rec["samples"]:
                ops, n_bytes = roofline.mel_work(s, m["n_mels"])
                need += roofline.bound_s(n_bytes, ops)
        else:
            emissions, frames, lanes, _ = _work(ctx, rec, kind)
            ops, n_bytes = roofline.loop_work(m, emissions, frames, lanes)
            need += roofline.bound_s(n_bytes, ops)
        spent += t
    return need / spent * 100 if spent else None


def mfu(ctx, kind: str) -> Optional[float]:
    """Model FLOPs (encoder over the real frames, prediction net and joint
    for the emitted tokens) of the calls in the traced window, prorated by
    their overlap with it, over its wall time, against the bf16 peak (%)."""
    tr, sp, m = ctx.get("trace"), ctx.get("spans"), ctx["m"]
    if tr is None or sp is None:
        return None
    recs = sp.dispatches if kind == "dispatch" else sp.ticks
    flops = 0.0
    for rec in recs:
        over = min(rec["t1"], tr["p1"]) - max(rec["t0"], tr["p0"])
        if over <= 0:
            continue
        emissions, frames, _, lanes = _work(ctx, rec, kind)
        f = sum(roofline.encoder_flops(m, feat, keys)
                for feat, _, keys in lanes)
        f += roofline.decoder_flops(m, emissions, frames)
        flops += f * over / max(rec["t1"] - rec["t0"], 1e-9)
    if not flops:
        return None
    return flops / (tr["p1"] - tr["p0"]) / roofline.PEAK_OPS["bf16"] * 100


def idle_share(ctx) -> Optional[float]:
    """1 - the device's busy time over the traced window (%)."""
    tr = ctx.get("trace")
    if tr is None or not len(tr["names"]):
        return None
    return (1.0 - trace.busy_seconds(tr) / (tr["p1"] - tr["p0"])) * 100
