"""Application state: the serving layer's container (port of
server/state.py, without the reload guard and the CPU-affinity plan, which
the port does not serve yet).

Besides the batch surface it holds the streams' admission (the stream
semaphore, the active-stream registry, the session threads) and, in native
mode on a causal preset, the shared lane engine with its lock and its
ticker thread. The batcher's dispatches and the lane ticker's chunk steps
launch on the device's default stream (PyTorch gives every thread the
same one), so their cooperative kernel grids never run at once.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Dict, Optional

from ..config import Config
from ..errors import CapacityExceededError
from ..reliability import CircuitBreaker, GracefulShutdown, get_logger
from ..vocab import Vocabulary
from ..runtime import AsrPipeline, ContinuousBatcher
from ..runtime.lane_engine import StreamingLaneEngine
from .metrics import PrometheusMetrics, ServiceMetrics

log = get_logger("asr.state")


class TryAcquireSemaphore:
    """Counting semaphore with non-blocking acquire (503 instead of a
    queue). Only touched from the event-loop thread."""

    def __init__(self, limit: int):
        self.limit = limit
        self._held = 0

    def try_acquire(self) -> bool:
        if self._held >= self.limit:
            return False
        self._held += 1
        return True

    def release(self) -> None:
        self._held = max(0, self._held - 1)

    @property
    def available(self) -> int:
        return self.limit - self._held


class AppState:
    def __init__(self, pipeline: AsrPipeline, vocab: Vocabulary,
                 config: Optional[Config] = None):
        self.config = config or pipeline.config
        self.pipeline = pipeline
        self.vocab = vocab
        self.metrics = ServiceMetrics(self.config.max_concurrent_streams,
                                      self.config.max_concurrent_batches)
        self.prometheus: Optional[PrometheusMetrics] = None
        if self.config.metrics_backend == "prometheus":
            self.prometheus = PrometheusMetrics(self.metrics)
        self.stream_semaphore = TryAcquireSemaphore(
            self.config.max_concurrent_streams)
        self.batch_semaphore = TryAcquireSemaphore(
            self.config.max_concurrent_batches)
        self.active_streams: Dict[str, object] = {}
        # load-shed rejections must not count as device failures
        self.breaker = CircuitBreaker(
            excluded_exceptions=(CapacityExceededError,))
        self.shutdown = GracefulShutdown()
        # one dispatch thread: work for one device serializes anyway
        self.inference_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="device-dispatch")
        # session threads run each stream's host work (buffering, weaving,
        # featurizing) and block on the batcher or the lane engine: one per
        # admissible stream
        self.session_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.config.max_concurrent_streams + 2,
            thread_name_prefix="stream-session")
        self.batcher = ContinuousBatcher(pipeline, self.inference_executor)
        if self.prometheus:
            self.batcher.prometheus = self.prometheus
            pipeline.on_compile = self.prometheus.compile_count.inc
            pipeline.on_beam_path = (
                lambda p: self.prometheus.beam_path.labels(path=p).inc())
            self.breaker.on_state_change = self._on_breaker_state
            self.prometheus.queue_depth_fn = self.batcher.queue_depth

        # native mode: one lane engine batches all streams into one chunk
        # step per tick
        self.lane_engine: Optional[StreamingLaneEngine] = None
        self.lane_lock: Optional[threading.Lock] = None
        if (self.config.streaming_mode == "native"
                and pipeline.model.config.causal):
            cfg = self.config
            self.lane_engine = StreamingLaneEngine(
                pipeline, n_lanes=cfg.max_lanes,
                chunk_frames=cfg.native_chunk_frames, norm=cfg.native_norm,
                max_symbols=cfg.max_symbols_per_step,
                max_total=cfg.max_total_tokens)
            self.lane_lock = threading.Lock()
            if self.prometheus:
                self.lane_engine.prometheus = self.prometheus
                self.prometheus.lane_live_fn = \
                    lambda: self.lane_engine.live_lanes
            # one ticker thread advances the engine whenever a lane has a
            # chunk; session threads only feed and read transcripts, so
            # every tick batches all ready lanes (session threads ticking
            # under the lock would form a convoy of one-lane ticks)
            self._lane_ticker_stop = threading.Event()
            self.lane_ticker = threading.Thread(
                target=self._tick_loop, name="lane-ticker", daemon=True)
            self.lane_ticker.start()

    def _tick_loop(self) -> None:
        eng = self.lane_engine
        while not self._lane_ticker_stop.is_set():
            did = False
            # pending() reads the host lists without the lock; tick()
            # recomputes readiness under it, so a stale view costs one
            # 5 ms wait
            if eng.pending():
                with self.lane_lock:
                    try:
                        did = bool(eng.tick())
                    except Exception:  # noqa: BLE001 — the ticker lives on
                        # tick() failed the step's lanes: their streams end
                        # with an error frame, the others go on
                        log.exception("lane tick failed")
                        self.metrics.record_error()
            if not did:
                self._lane_ticker_stop.wait(0.005)

    @property
    def lane_ticker_alive(self) -> bool:
        t = getattr(self, "lane_ticker", None)
        return t is not None and t.is_alive()

    def start_warmup_supervisor(self, idle_secs: float = 10.0) -> None:
        """The background bucket warmup, held back while native streams
        are live: without the lane engine it is
        ``pipeline.start_background_warmup()``; with it, warmup runs only
        after ``idle_secs`` with no live lane and stops (between buckets)
        when a lane goes live, so a bucket's first run never delays lane
        ticks. ``is_warm`` makes stop and start resumable."""
        eng = self.lane_engine
        if eng is None:
            self.pipeline.start_background_warmup()
            return
        self._warmup_sup_stop = threading.Event()

        def run():
            pipe = self.pipeline
            idle_since = time.monotonic()
            running = False
            while not self._warmup_sup_stop.is_set():
                if eng.live_lanes > 0:
                    idle_since = time.monotonic()
                    if running:
                        pipe.stop_background_warmup()
                        running = False
                elif running:
                    t = pipe._warmup_thread
                    if t is not None and not t.is_alive():
                        return  # every bucket warm (or warmup gave up)
                elif time.monotonic() - idle_since >= idle_secs:
                    pipe.start_background_warmup()
                    running = True
                self._warmup_sup_stop.wait(1.0)

        self._warmup_supervisor = threading.Thread(
            target=run, name="warmup-supervisor", daemon=True)
        self._warmup_supervisor.start()

    def _on_breaker_state(self, s) -> None:
        prom = self.prometheus
        prom.circuit_state.set(s.value)
        if s.name == "OPEN":
            prom.breaker_opens.inc()
        elif s.name == "CLOSED":
            prom.breaker_closes.inc()

    def close(self) -> None:
        if getattr(self, "_warmup_sup_stop", None) is not None:
            self._warmup_sup_stop.set()
        if getattr(self, "_lane_ticker_stop", None) is not None:
            self._lane_ticker_stop.set()
            # a daemon thread still launching at interpreter exit would
            # die inside the CUDA runtime
            self.lane_ticker.join(timeout=5.0)
        self.pipeline.stop_background_warmup()
        self.inference_executor.shutdown(wait=False, cancel_futures=True)
        self.session_executor.shutdown(wait=False, cancel_futures=True)
