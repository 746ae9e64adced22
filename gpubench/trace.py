"""The device trace of a traced run: ``torch.profiler`` over a few steady
seconds in the middle of the window, reduced to kernel intervals on the
host's monotonic clock.

The profiler's own clock is tied to the host's by one marker, a
``record_function`` entered at a known ``time.monotonic()``. Busy time is
the union of the kernel, copy and fill intervals inside the traced window
(the idle-share arithmetic of the port's ``tools/profile_torch_pipeline.
py``: 1 - union / span); idle gaps are labelled by the benchmark's host span
open at their midpoint.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

MARK = "gpubench.clock_mark"
LOCK_POLL_S = 0.0005  # how often the stop tries the device lock
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# what the host was doing in a gap: the innermost open span first
GAP_LABELS = {
    "dispatch": "host in a dispatch (staging, launch, reading back)",
    "tick": "host in a lane tick (chunk staging, launch, reading back)",
    "feed": "host in a stream's featurizer (lane feed)",
    "submit": "a request waiting in the batcher, none of the above",
    "http": "a handler or stream open, none of the above",
}


class DeviceTrace:
    """Start, stop and read one profiled window (CUDA only); kernels that
    run past its end while the profiler waits to stop lie outside it."""

    def __init__(self):
        self.prof = None
        self.p0 = self.p1 = self.mark = None

    def warm(self) -> None:
        """One empty profile in set-up, so that the profiler's first start
        inside the window does not pay its initialisation."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros((), device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.mark = time.monotonic()
        with record_function(MARK):
            torch.zeros(())  # an op inside the marker
        self.p0 = time.monotonic()

    async def stop(self, lock) -> None:
        """Close the traced window now, then stop the profiler on this
        thread (the event loop's, where it started) while it holds
        ``lock``: the pipeline's device lock, so that no replay is in
        flight on the dispatch thread while the profiler stops (a stop
        beside ``CUDAGraph.replay`` has hung). The lock is re-entrant, so
        the thread that takes it releases it; it is taken by polling, which
        leaves the loop serving while a dispatch ends."""
        self.p1 = time.monotonic()
        while not lock.acquire(blocking=False):
            await asyncio.sleep(LOCK_POLL_S)
        try:
            self.prof.stop()
        finally:
            lock.release()

    def read(self) -> dict:
        """Kernels as arrays of host-clock start and end, with names."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, "r", encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        mark_ts = next(e["ts"] for e in events if e.get("name") == MARK
                       and e.get("ph") == "X")
        names, starts, ends = [], [], []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                s = self.mark + (float(e["ts"]) - mark_ts) * 1e-6
                names.append(e["name"])
                starts.append(s)
                ends.append(s + float(e["dur"]) * 1e-6)
        return {"p0": self.p0, "p1": self.p1, "names": names,
                "starts": np.asarray(starts), "ends": np.asarray(ends)}


def busy_intervals(starts: np.ndarray, ends: np.ndarray, p0: float,
                   p1: float) -> np.ndarray:
    """The union of ``[start, end)`` clipped to ``[p0, p1]``, as an ``[n,
    2]`` array of disjoint intervals in order."""
    s, e = np.clip(starts, p0, p1), np.clip(ends, p0, p1)
    keep = e > s
    s, e = s[keep], e[keep]
    if s.size == 0:
        return np.zeros((0, 2))
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return np.stack([s[first], e[last]], axis=1)


def busy_seconds(tr: dict) -> float:
    iv = busy_intervals(tr["starts"], tr["ends"], tr["p0"], tr["p1"])
    return float((iv[:, 1] - iv[:, 0]).sum())


def _open_at(spans: List[tuple], kind: str, x: np.ndarray) -> np.ndarray:
    st = np.sort([s for k, s, _ in spans if k == kind])
    en = np.sort([e for k, _, e in spans if k == kind])
    return (np.searchsorted(st, x, side="right")
            - np.searchsorted(en, x, side="right")) > 0


def breakdown(tr: dict, spans: List[tuple], top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing (the benchmark's span open at each gap's
    midpoint)."""
    p0, p1 = tr["p0"], tr["p1"]
    s, e = np.clip(tr["starts"], p0, p1), np.clip(tr["ends"], p0, p1)
    per_op: Dict[str, float] = {}
    for name, d in zip(tr["names"], e - s):
        per_op[name] = per_op.get(name, 0.0) + float(d)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    iv = busy_intervals(tr["starts"], tr["ends"], p0, p1)
    edges = np.concatenate([[p0], iv.ravel(), [p1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mid = gaps.mean(axis=1)
    label = np.full(mid.size, "no request or stream open", dtype=object)
    for kind in reversed(list(GAP_LABELS)):
        label[_open_at(spans, kind, mid)] = GAP_LABELS[kind]
    sums: Dict[str, list] = {}
    for lab, (a, b) in zip(label, gaps):
        acc = sums.setdefault(lab, [0.0, 0, 0.0])
        acc[0] += b - a
        acc[1] += 1
        acc[2] = max(acc[2], b - a)
    idle = [[f"{lab}: {n} gaps, longest {longest * 1e3:.6f} ms", total]
            for lab, (total, n, longest) in sorted(
                sums.items(), key=lambda kv: -kv[1][0])][:top]
    return {"device_ops": [[n, d] for n, d in ops], "idle_gaps": idle}


def kernel_time_in(tr: dict, pattern: str, t0: float, t1: float
                   ) -> Optional[float]:
    """Seconds of kernels named with ``pattern`` that start in ``[t0,
    t1)``; None when none does."""
    cache = tr.setdefault("by_pattern", {})
    if pattern not in cache:
        cache[pattern] = np.asarray([i for i, n in enumerate(tr["names"])
                                     if pattern in n], dtype=np.int64)
    idx = cache[pattern]
    if not idx.size:
        return None
    s = tr["starts"][idx]
    inside = (s >= t0) & (s < t1)
    if not inside.any():
        return None
    return float((tr["ends"][idx][inside] - s[inside]).sum())
