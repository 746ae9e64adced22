"""Continuous batching (port of runtime/batcher.py).

Requests queue up; a dispatcher packs whatever is pending, up to the largest
batch bucket and waiting at most ``batch_window_ms`` for stragglers, into
one padded device call of the pipeline, then fans results back out to
per-request futures. Pending work is grouped by audio-length bucket so a
short request is not padded to the longest one, and each group is capped at
the largest batch bucket already warm for its length. In beam mode
(``decoding_mode="beam"``) groups run the beam program, with
``beam_n_best`` alternatives; stream state is not carried there (beam serves
the batch endpoint). Admission is bounded per class: batch POSTs
(``kind="batch"``) and the chunked WebSocket streams' window re-decodes
(``kind="stream"``, :meth:`ContinuousBatcher.submit_from_thread`) each
have a queue of ``inference_queue_size``; a full queue rejects with 503,
and each dispatch takes from both round-robin, so neither class starves the
other. Stream windows carry their decoder state per lane, so both classes
share dispatches.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..errors import CapacityExceededError
from ..types import Transcription
from ..utils.async_patterns import ErrorRecoveryManager
from .pipeline import AsrPipeline, StreamState


class BatcherStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.dispatches = 0
        self.lanes_total = 0
        self.max_lanes_seen = 0

    def record(self, lanes: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.lanes_total += lanes
            self.max_lanes_seen = max(self.max_lanes_seen, lanes)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "lanes_total": self.lanes_total,
                "mean_lanes": (self.lanes_total / self.dispatches
                               if self.dispatches else 0.0),
                "max_lanes": self.max_lanes_seen,
            }


class ContinuousBatcher:
    """Async collector in front of the pipeline."""

    def __init__(self, pipeline: AsrPipeline, executor,
                 window_ms: Optional[float] = None,
                 max_lanes: Optional[int] = None):
        self.pipeline = pipeline
        self.executor = executor
        cfg = pipeline.config
        self.window_s = (window_ms if window_ms is not None
                         else cfg.batch_window_ms) / 1e3
        self.max_lanes = max_lanes or max(cfg.batch_buckets)
        self.stats = BatcherStats()
        self.prometheus = None  # optional PrometheusMetrics (AppState)
        self._retry = ErrorRecoveryManager(
            max_retries=2, base_delay_s=0.05,
            retryable=(RuntimeError, TimeoutError))
        self._maxsize = max(cfg.inference_queue_size, self.max_lanes)
        self._pending = {"batch": deque(), "stream": deque()}
        self._work = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    async def start(self) -> None:
        """Idempotent: a second start() never spawns a second dispatcher."""
        if self._task is not None and not self._task.done():
            return
        self._loop = asyncio.get_running_loop()
        self._task = asyncio.create_task(self._run(), name="batcher")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def submit(self, samples: np.ndarray,
                     stream_state: Optional[StreamState] = None,
                     kind: str = "batch"
                     ) -> Tuple[Transcription, StreamState]:
        """Queue one decode of admission class ``kind`` ("batch" or
        "stream"; ``stream_state`` carries a stream's decoder state);
        resolves when its device batch completes. Raises
        CapacityExceededError when that class's queue is full."""
        if kind not in self._pending:
            raise ValueError(
                f"unknown admission class {kind!r}; expected one of "
                f"{sorted(self._pending)}")
        q = self._pending[kind]
        if len(q) >= self._maxsize:
            raise CapacityExceededError(f"{kind} inference queue is full")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        q.append((samples, stream_state, fut))
        self._work.set()
        return await fut

    def submit_from_thread(self, samples: np.ndarray,
                           stream_state: Optional[StreamState] = None,
                           timeout: Optional[float] = None
                           ) -> Tuple[Transcription, StreamState]:
        """Blocking submit from a worker thread (a chunked stream's
        session thread), in the "stream" class."""
        if self._loop is None:
            raise RuntimeError("batcher not started")
        cfut = asyncio.run_coroutine_threadsafe(
            self.submit(samples, stream_state, kind="stream"), self._loop)
        return cfut.result(timeout)

    def queue_depth(self) -> int:
        """Pending admissions of both classes."""
        return sum(len(q) for q in self._pending.values())

    def _take_fair(self) -> list:
        """Up to max_lanes pending items, round-robin across the classes."""
        out: list = []
        while len(out) < self.max_lanes:
            took = False
            for q in self._pending.values():
                if q and len(out) < self.max_lanes:
                    out.append(q.popleft())
                    took = True
            if not took:
                break
        return out

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            while not self.queue_depth():
                self._work.clear()
                await self._work.wait()
            deadline = loop.time() + self.window_s
            while self.queue_depth() < self.max_lanes:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                self._work.clear()
                try:
                    await asyncio.wait_for(self._work.wait(),
                                           timeout=remaining)
                except asyncio.TimeoutError:
                    break
            await self._dispatch(self._take_fair())

    def _group_by_bucket(self, batch, mode: str = "greedy") -> List[list]:
        """Group by length bucket; cap each group at the largest warm batch
        bucket for its length in ``mode`` (a fully cold length dispatches
        whole)."""
        groups: dict = {}
        for item in batch:
            bucket = self.pipeline._bucket_len(item[0].shape[0])
            groups.setdefault(bucket, []).append(item)
        out: List[list] = []
        for bucket, group in groups.items():
            cap = self.pipeline.warm_batch_cap(bucket, mode)
            natural = self.pipeline._bucket_batch(len(group))
            if cap == 0 or self.pipeline.is_warm(natural, bucket, mode):
                out.append(group)
                continue
            out.extend(group[i:i + cap] for i in range(0, len(group), cap))
        return out

    def _record_dispatch(self, program: str, lanes: int, duration_s: float,
                         ok: bool) -> None:
        if ok:
            self.stats.record(lanes)
        if self.prometheus is not None:
            self.prometheus.observe_dispatch(program, duration_s, ok)
            if ok:
                self.prometheus.batch_lanes.observe(lanes)

    async def _dispatch(self, batch) -> None:
        beam = self.pipeline.config.decoding_mode == "beam"
        mode = "beam" if beam else "greedy"
        loop = asyncio.get_running_loop()
        try:
            groups = self._group_by_bucket(batch, mode)
        except Exception as e:  # noqa: BLE001 — malformed submission
            for *_, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            return
        n_best = self.pipeline.config.beam_n_best
        for group in groups:
            samples = [item[0] for item in group]
            states = [item[1] for item in group]
            futures = [item[2] for item in group]
            # timed inside the executor, per attempt: device-dispatch
            # latency, not queueing or retry backoff; None = never ran
            dev_s = [None]

            def call():
                ta = time.perf_counter()
                try:
                    if beam:
                        return self.pipeline.decode_beam_batch(
                            samples, n_best=n_best)
                    return self.pipeline.decode_samples_batch(samples,
                                                              states)
                finally:
                    dev_s[0] = time.perf_counter() - ta

            try:
                out = await self._retry.run(lambda: loop.run_in_executor(
                    self.executor, call))
            except Exception as e:  # noqa: BLE001 — fan the error out
                if dev_s[0] is not None:
                    self._record_dispatch(mode, len(group), dev_s[0],
                                          ok=False)
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._record_dispatch(mode, len(group), dev_s[0], ok=True)
            for i, fut in enumerate(futures):
                if fut.done():
                    continue
                if beam:
                    res, feat_lens, enc_lens = out
                    fut.set_result((self.pipeline.beam_transcription(
                        res, i, samples[i].shape[0], feat_lens[i],
                        enc_lens[i]), None))
                else:
                    res, feat_lens, enc_lens, new_states = out
                    fut.set_result((self.pipeline._to_transcription(
                        res, i, samples[i].shape[0], int(feat_lens[i]),
                        int(enc_lens[i])), new_states[i]))
