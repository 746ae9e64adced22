"""Service metrics (port of server/metrics.py; that module's package imports
jax through ``server/__init__`` -> ``app`` -> ``runtime``), the streams'
and the lane engine's included.

- :class:`ServiceMetrics`: JSON counters served at /metrics.
- :class:`PrometheusMetrics`: the prometheus_client series this port feeds,
  served at /metrics when ``config.metrics_backend == "prometheus"``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional


class ServiceMetrics:
    """Counters behind a lock (read-modify-write from several threads)."""

    def __init__(self, max_streams: int, max_batches: int):
        self._lock = threading.Lock()
        self.start_time = time.time()
        self.max_streams = max_streams
        self.max_batches = max_batches
        self.active_streams = 0
        self.active_batches = 0
        self.total_streams = 0
        self.total_batches = 0
        self.rejections = 0
        self.errors = 0

    def increment_stream(self) -> None:
        with self._lock:
            self.active_streams += 1
            self.total_streams += 1

    def decrement_stream(self) -> None:
        with self._lock:
            self.active_streams = max(0, self.active_streams - 1)

    def increment_batch(self) -> None:
        with self._lock:
            self.active_batches += 1
            self.total_batches += 1

    def decrement_batch(self) -> None:
        with self._lock:
            self.active_batches = max(0, self.active_batches - 1)

    def record_rejection(self) -> None:
        with self._lock:
            self.rejections += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def reset_batch_count(self) -> None:
        """Zombie-request reset (ref: handlers.rs:237-243)."""
        with self._lock:
            self.active_batches = 0

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active_streams": self.active_streams,
                "max_streams": self.max_streams,
                "active_batches": self.active_batches,
                "max_batches": self.max_batches,
                "total_streams": self.total_streams,
                "total_batches": self.total_batches,
                "rejections": self.rejections,
                "errors": self.errors,
                "uptime_seconds": round(time.time() - self.start_time, 1),
            }


class PrometheusMetrics:
    """Request, dispatch and breaker series (names as in the reference)."""

    def __init__(self, metrics: ServiceMetrics):
        from prometheus_client import (CollectorRegistry, Counter, Gauge,
                                       Histogram)
        self.registry = r = CollectorRegistry()
        self._svc = metrics
        self.requests_total = Counter(
            "asr_requests_total", "Total ASR requests", ["kind", "status"],
            registry=r)
        self.requests_failed = Counter(
            "asr_requests_failed_total", "Failed ASR requests",
            ["kind", "error"], registry=r)
        self.inference_duration = Histogram(
            "asr_inference_duration_seconds", "End-to-end inference latency",
            ["kind"], registry=r,
            buckets=(.005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5, 10))
        self.audio_seconds_total = Counter(
            "asr_audio_seconds_total", "Seconds of audio processed",
            registry=r)
        self.active_streams = Gauge(
            "asr_active_streams", "Active WebSocket streams", registry=r)
        self.active_batches = Gauge(
            "asr_active_batches", "Active batch requests", registry=r)
        self.websocket_messages = Counter(
            "asr_websocket_messages_total", "WebSocket messages",
            ["direction"], registry=r)
        self.ws_connections = Counter(
            "asr_websocket_connections_total", "WebSocket connections opened",
            registry=r)
        self.ws_active = Gauge(
            "asr_websocket_connections_active", "Open WebSocket connections",
            registry=r)
        self.batch_lanes = Histogram(
            "asr_batch_lanes", "Lanes per device dispatch", registry=r,
            buckets=(1, 2, 4, 8, 16, 32))
        self.circuit_state = Gauge(
            "asr_circuit_breaker_state", "0=closed 1=half-open 2=open",
            registry=r)
        self.compile_count = Counter(
            "asr_xla_compilations_total",
            "Bucket programs run for the first time", registry=r)
        self.dispatch_duration = Histogram(
            "asr_device_dispatch_duration_seconds",
            "Pipeline call latency per attempt", ["program"], registry=r,
            buckets=(.005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5))
        self.dispatches_total = Counter(
            "asr_device_dispatches_total", "Device dispatches", ["program"],
            registry=r)
        self.dispatch_failures = Counter(
            "asr_device_dispatch_failures_total", "Failed device dispatches",
            ["program"], registry=r)
        self.breaker_opens = Counter(
            "asr_circuit_breaker_opens_total", "Breaker CLOSED->OPEN trips",
            registry=r)
        self.breaker_closes = Counter(
            "asr_circuit_breaker_closes_total", "Breaker ->CLOSED recoveries",
            registry=r)
        self.breaker_rejections = Counter(
            "asr_circuit_breaker_rejected_requests_total",
            "Requests rejected while the breaker was open", registry=r)
        self.audio_conversion = Histogram(
            "asr_audio_conversion_duration_seconds",
            "PCM16 -> f32 conversion latency", registry=r,
            buckets=(.0001, .00025, .0005, .001, .0025, .005, .01, .05))
        self.audio_chunk_bytes = Histogram(
            "asr_audio_chunk_size_bytes", "Audio payload sizes", registry=r,
            buckets=(1024, 4096, 16384, 65536, 262144, 1048576, 4194304))
        self.queue_depth = Gauge(
            "asr_inference_queue_depth", "Batcher admission queue depth",
            registry=r)
        self.queue_depth_fn = None
        # the native mode's lane engine (its hot path)
        self.lane_ticks = Counter(
            "asr_lane_ticks_total", "Lane-engine chunk steps", registry=r)
        self.lane_tick_duration = Histogram(
            "asr_lane_tick_duration_seconds",
            "Chunk-step latency (all ready lanes, one step)", registry=r,
            buckets=(.005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5))
        self.lane_lanes_per_tick = Histogram(
            "asr_lane_lanes_per_tick", "Ready lanes advanced per tick",
            registry=r, buckets=(1, 2, 4, 8, 16, 32, 64))
        self.lane_live = Gauge(
            "asr_lane_live", "Attached (live) lane-engine lanes", registry=r)
        self.lane_sheds = Counter(
            "asr_lane_sheds_total",
            "Stream attaches rejected: all lanes busy", registry=r)
        self.lane_live_fn = None
        self.beam_path = Counter(
            "asr_beam_decode_path_total",
            "Beam decodes by program (graphs past the kernel's state cap "
            "run the plain scan)", ["path"], registry=r)

    def observe_request(self, kind: str, status: str,
                        duration_s: Optional[float] = None,
                        audio_s: Optional[float] = None,
                        error: Optional[str] = None) -> None:
        self.requests_total.labels(kind=kind, status=status).inc()
        if duration_s is not None:
            self.inference_duration.labels(kind=kind).observe(duration_s)
        if audio_s is not None:
            self.audio_seconds_total.inc(audio_s)
        if status != "ok":
            self.requests_failed.labels(
                kind=kind, error=error or "internal").inc()

    def observe_dispatch(self, program: str, duration_s: float,
                         ok: bool = True) -> None:
        self.dispatches_total.labels(program=program).inc()
        if ok:
            self.dispatch_duration.labels(program=program).observe(duration_s)
        else:
            self.dispatch_failures.labels(program=program).inc()

    def observe_lane_tick(self, lanes: int, duration_s: float) -> None:
        self.lane_ticks.inc()
        self.lane_tick_duration.observe(duration_s)
        self.lane_lanes_per_tick.observe(lanes)

    def exposition(self) -> bytes:
        from prometheus_client import generate_latest
        self.active_streams.set(self._svc.active_streams)
        self.active_batches.set(self._svc.active_batches)
        if self.queue_depth_fn is not None:
            self.queue_depth.set(self.queue_depth_fn())
        if self.lane_live_fn is not None:
            self.lane_live.set(self.lane_live_fn())
        return generate_latest(self.registry)
