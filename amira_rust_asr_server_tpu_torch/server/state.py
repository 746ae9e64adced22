"""Application state: the serving layer's container (port of
server/state.py, without the native-streaming lane engine, the reload guard
and the CPU-affinity plan, which this slice does not serve)."""

from __future__ import annotations

import concurrent.futures
from typing import Optional

from ..config import Config
from ..errors import CapacityExceededError
from ..reliability import CircuitBreaker, GracefulShutdown
from ..vocab import Vocabulary
from ..runtime import AsrPipeline, ContinuousBatcher
from .metrics import PrometheusMetrics, ServiceMetrics


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
        self.batch_semaphore = TryAcquireSemaphore(
            self.config.max_concurrent_batches)
        # load-shed rejections must not count as device failures
        self.breaker = CircuitBreaker(
            excluded_exceptions=(CapacityExceededError,))
        self.shutdown = GracefulShutdown()
        # one dispatch thread: work for one device serializes anyway
        self.inference_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="device-dispatch")
        self.batcher = ContinuousBatcher(pipeline, self.inference_executor)
        if self.prometheus:
            self.batcher.prometheus = self.prometheus
            pipeline.on_compile = self.prometheus.compile_count.inc
            pipeline.on_beam_path = (
                lambda p: self.prometheus.beam_path.labels(path=p).inc())
            self.breaker.on_state_change = self._on_breaker_state
            self.prometheus.queue_depth_fn = self.batcher.queue_depth

    def _on_breaker_state(self, s) -> None:
        prom = self.prometheus
        prom.circuit_state.set(s.value)
        if s.name == "OPEN":
            prom.breaker_opens.inc()
        elif s.name == "CLOSED":
            prom.breaker_closes.inc()

    def close(self) -> None:
        self.pipeline.stop_background_warmup()
        self.inference_executor.shutdown(wait=False, cancel_futures=True)
