"""The port's own spans in a run's window, and the device's idle gaps
labelled by them.

The port records every finished span in a bounded ring
(``amira_rust_asr_server_tpu_torch/reliability/tracing.py``): ``(name,
span_id, parent_id, request_id, t0, t1, attrs)`` on ``time.monotonic()``,
the clock ``trace.py`` maps every kernel onto, so spans and device
intervals compare with no conversion. A port without the recorder, or a
ring that lost spans inside the window, gives None (the metric is left
out of the line).

Each idle gap of the traced window is labelled by the spans open at its
midpoint, in this order: the dispatch thread's innermost open
``dispatch*`` span; else the event loop's innermost open ``http.decode``,
``http.respond``, ``batcher.fanout`` or ``batcher.window``; else
``batcher.handoff``; else "http.read open, nothing else"; else "no program
span open".
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import trace

NAME, START, END = 0, 4, 5
LOOP = ("http.decode", "http.respond", "batcher.fanout", "batcher.window")
READ_ONLY = "http.read open, nothing else"
UNLABELLED = "no program span open"


def snapshot(ctx) -> Optional[tuple]:
    """The port's ring, copied once per run: (spans, complete_from), or
    None when the port has no recorder."""
    if "program_ring" not in ctx:
        try:
            from amira_rust_asr_server_tpu_torch.reliability import tracing
        except ImportError:
            tracing = None
        take = getattr(tracing, "snapshot", None)
        ctx["program_ring"] = tuple(take()) if take is not None else None
    return ctx["program_ring"]


def window_spans(ctx) -> Optional[List[tuple]]:
    """The port's spans that start in the window; None without a recorder,
    or when the ring dropped spans that ended after the window opened."""
    ring = snapshot(ctx)
    if ring is None:
        return None
    spans, complete_from = ring
    t0, t1 = ctx["t0"], ctx["t1"]
    if complete_from >= t0:
        return None
    return [s for s in spans if t0 <= s[START] < t1]


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean wall of the spans ``name`` that start in the window (ms)."""
    spans = window_spans(ctx)
    if spans is None:
        return None
    d = [s[END] - s[START] for s in spans if s[NAME] == name]
    return sum(d) * 1e3 / len(d) if d else None


def _gaps(tr: dict) -> np.ndarray:
    """The device's idle gaps in the traced window, ``[n, 2]``."""
    p0, p1 = tr["p0"], tr["p1"]
    iv = trace.busy_intervals(tr["starts"], tr["ends"], p0, p1)
    edges = np.concatenate([[p0], iv.ravel(), [p1]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def gap_labels(gaps: np.ndarray, spans: List[tuple],
               chunk: int = 2048) -> np.ndarray:
    """One label per gap, from the spans open at its midpoint."""
    mid = gaps.mean(axis=1) if len(gaps) else np.zeros(0)
    label = np.full(mid.size, UNLABELLED, dtype=object)
    if mid.size:
        lo, hi = gaps[:, 0].min(), gaps[:, 1].max()
        spans = [s for s in spans if s[START] < hi and s[END] > lo]
    if not mid.size or not spans:
        return label
    names = np.array([s[NAME] for s in spans], dtype=object)
    s0 = np.array([s[START] for s in spans])
    s1 = np.array([s[END] for s in spans])
    # lowest priority first: each later class overwrites where it is open
    classes = [
        ("read", names == "http.read"),
        ("handoff", names == "batcher.handoff"),
        ("loop", np.isin(names, LOOP)),
        ("dispatch", np.array([n.startswith("dispatch") for n in names])),
    ]
    for kind, pick in classes:
        idx = np.flatnonzero(pick)
        if not idx.size:
            continue
        a0, a1, an = s0[idx], s1[idx], names[idx]
        for c in range(0, mid.size, chunk):
            x = mid[c:c + chunk, None]
            opened = (a0[None, :] <= x) & (a1[None, :] > x)
            hit = opened.any(axis=1)
            if kind == "read":
                label[c:c + chunk][hit] = READ_ONLY
                continue
            # the innermost: the open span that started last
            last = np.where(opened, a0[None, :], -np.inf).argmax(axis=1)
            label[c:c + chunk][hit] = an[last[hit]]
    return label


def idle_table(tr: dict, spans: List[tuple]) -> Dict[str, list]:
    """Idle seconds, gap count and the longest gap (s) per label."""
    gaps = _gaps(tr)
    out: Dict[str, list] = {}
    for lab, (a, b) in zip(gap_labels(gaps, spans), gaps):
        acc = out.setdefault(lab, [0.0, 0, 0.0])
        acc[0] += b - a
        acc[1] += 1
        acc[2] = max(acc[2], b - a)
    return out


def _union(iv: np.ndarray) -> np.ndarray:
    if not len(iv):
        return np.zeros((0, 2))
    return trace.busy_intervals(iv[:, 0], iv[:, 1], iv[:, 0].min(),
                                iv[:, 1].max())


def _inside(iv: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Whether each point of ``x`` lies inside the disjoint sorted
    intervals ``iv``."""
    if not len(iv):
        return np.zeros(x.shape, bool)
    k = np.searchsorted(iv[:, 0], x, side="right") - 1
    return (k >= 0) & (x < iv[np.maximum(k, 0), 1])


def idle_share_while(tr: dict, spans: List[tuple], open_name: str,
                     closed_name: str) -> float:
    """Share (%) of the traced window in which the device was idle, a span
    ``closed_name`` was not open and a span ``open_name`` was."""
    p0, p1 = tr["p0"], tr["p1"]
    busy = trace.busy_intervals(tr["starts"], tr["ends"], p0, p1)

    def of(name):
        iv = np.array([(s[START], s[END]) for s in spans if s[NAME] == name],
                      dtype=float).reshape(-1, 2)
        return _union(np.clip(iv, p0, p1))

    want, avoid = of(open_name), of(closed_name)
    cuts = np.unique(np.concatenate([[p0, p1], busy.ravel(), want.ravel(),
                                     avoid.ravel()]))
    cuts = cuts[(cuts >= p0) & (cuts <= p1)]
    mid = (cuts[:-1] + cuts[1:]) / 2
    keep = _inside(want, mid) & ~_inside(avoid, mid) & ~_inside(busy, mid)
    return float(np.diff(cuts)[keep].sum()) / (p1 - p0) * 100


def _traced(ctx) -> Optional[tuple]:
    """(the device trace, the port's spans in the window), or None without
    a device trace or the spans."""
    tr = ctx.get("trace")
    if tr is None or not len(tr["names"]):
        return None
    spans = window_spans(ctx)
    return None if spans is None else (tr, spans)


def idle_body_decode(ctx) -> Optional[float]:
    """The traced window's share (%) in which the device was idle, no
    ``dispatch`` was open and an ``http.decode`` was."""
    got = _traced(ctx)
    return None if got is None else idle_share_while(*got, "http.decode",
                                                     "dispatch")


def report(ctx) -> Optional[dict]:
    """:func:`summary` of a run's traced window (``span_report.py``), or
    None without a device trace or the spans."""
    got = _traced(ctx)
    return None if got is None else summary(ctx, *got)


def summary(ctx, tr: dict, spans: List[tuple]) -> dict:
    """The traced window's idle time by program-span label, the share they
    label, and the program's spans beside the benchmark's own wrappers."""
    table = idle_table(tr, spans)
    idle = sum(v[0] for v in table.values())
    labelled = idle - table.get(UNLABELLED, [0.0])[0]

    def mean(name):
        d = [s[END] - s[START] for s in spans if s[NAME] == name]
        return sum(d) * 1e3 / len(d) if d else None

    roots = {s[1]: s for s in spans if s[NAME] == "http.batch"}
    child = sum(s[END] - s[START] for s in spans
                if s[2] in roots and s[NAME].startswith("http."))
    root_s = sum(s[END] - s[START] for s in roots.values())
    bench = {}
    if ctx.get("spans") is not None:
        for kind in ("http", "dispatch"):
            d = [e - s for k, s, e in ctx["spans"].spans
                 if k == kind and ctx["t0"] <= s < ctx["t1"]]
            bench[kind] = sum(d) * 1e3 / len(d) if d else None
    return {
        "idle_s": idle,
        "labelled_share": labelled / idle * 100 if idle else None,
        "idle_by_label": {k: {"s": v[0], "gaps": v[1], "longest_ms":
                              v[2] * 1e3}
                          for k, v in sorted(table.items(),
                                             key=lambda kv: -kv[1][0])},
        "program_ms": {n: mean(n) for n in (
            "http.batch", "http.read", "http.decode", "http.wait",
            "http.respond", "batcher.window", "batcher.handoff",
            "batcher.fanout", "dispatch", "dispatch.lock", "dispatch.stage",
            "dispatch.run", "dispatch.readback", "dispatch.capture")},
        "http_children_cover": child / root_s * 100 if root_s else None,
        "benchmark_ms": bench,
    }
