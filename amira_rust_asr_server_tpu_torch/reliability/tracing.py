"""Structured logging / tracing.

Parity role of the reference's tracing stack (ref:
src/reliability/tracing_config.rs:16-233): JSON structured logs, env-filter
style level control, span-like request context fields, and a real
OpenTelemetry span exporter — OTLP/HTTP JSON encoded with the stdlib (no
SDK in the image) — that degrades gracefully when no collector is
reachable (the reference's Jaeger fallback behavior,
tracing_config.rs:39-111).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import queue
import secrets
import sys
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional

_request_ctx: contextvars.ContextVar[Dict[str, Any]] = \
    contextvars.ContextVar("asr_request_ctx", default={})

_exporter: Optional["OtlpHttpExporter"] = None


class OtlpHttpExporter:
    """Minimal OTLP/HTTP JSON trace exporter (one POST per flush batch).

    The OpenTelemetry SDK isn't in the image, so spans are encoded to the
    OTLP JSON wire format by hand and POSTed to ``<endpoint>/v1/traces``
    from a daemon thread. After ``max_failures`` consecutive delivery
    failures the exporter disables itself and logs once — tracing must
    never take the server down (parity with the reference's graceful
    Jaeger fallback, ref: tracing_config.rs:39-64).
    """

    def __init__(self, endpoint: str,
                 service_name: str = "amira-asr-tpu-server",
                 flush_interval_s: float = 2.0, max_queue: int = 2048,
                 max_failures: int = 5, timeout_s: float = 2.0):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.timeout_s = timeout_s
        self.max_failures = max_failures
        self._queue: "queue.Queue[dict]" = queue.Queue(maxsize=max_queue)
        self._failures = 0
        self.disabled = False
        self.exported = 0  # spans delivered (observability/tests)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="otel-export",
                                        daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------
    def export_span(self, name: str, start_ns: int, end_ns: int,
                    attributes: Dict[str, Any], ok: bool = True) -> None:
        if self.disabled:
            return
        span = {
            "traceId": secrets.token_hex(16),
            "spanId": secrets.token_hex(8),
            "name": name,
            "kind": 2,  # SPAN_KIND_SERVER
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": [
                {"key": str(k), "value": _otlp_value(v)}
                for k, v in attributes.items() if v is not None],
            "status": {"code": 1 if ok else 2},
        }
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            pass  # shed under pressure; never block the request path

    # -- consumer side ------------------------------------------------------
    def _drain(self) -> list:
        spans = []
        while len(spans) < 512:
            try:
                spans.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return spans

    def _post(self, spans: list) -> None:
        import urllib.request
        body = json.dumps({"resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": self.service_name}}]},
            "scopeSpans": [{"scope": {"name": "asr"}, "spans": spans}],
        }]}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=self.timeout_s).read()

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            self.flush()
        self.flush()

    def flush(self) -> None:
        spans = self._drain()
        if not spans or self.disabled:
            return
        try:
            self._post(spans)
            self.exported += len(spans)
            self._failures = 0
        except Exception as e:  # noqa: BLE001 — collector down/unreachable
            self._failures += 1
            if self._failures >= self.max_failures:
                self.disabled = True
                get_logger().warning(
                    "otel export disabled after %d failures (%s); spans "
                    "remain in JSON logs", self._failures, e)
                return
            # requeue for the next flush so a recovering collector still
            # gets the batch (and consecutive failures actually accumulate
            # toward the disable threshold); overflow is shed
            for span in spans:
                try:
                    self._queue.put_nowait(span)
                except queue.Full:
                    break

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _otlp_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def get_exporter() -> Optional[OtlpHttpExporter]:
    return _exporter


def set_exporter(exporter: Optional[OtlpHttpExporter]) -> None:
    global _exporter
    if _exporter is not None:
        _exporter.shutdown()
    _exporter = exporter


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        payload.update(_request_ctx.get())
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        if record.exc_info and record.exc_info[0]:
            payload["exception"] = self.formatException(record.exc_info)
        return json.dumps(payload, ensure_ascii=False)


def init_tracing(level: Optional[str] = None, json_logs: bool = True,
                 otel_endpoint: Optional[str] = None) -> logging.Logger:
    """Initialize the logging pipeline (ref: init_tracing,
    tracing_config.rs:39-111). Level from arg > ASR_LOG env > INFO."""
    level = (level or os.environ.get("ASR_LOG", "INFO")).upper()
    root = logging.getLogger("asr")
    root.handlers.clear()
    handler = logging.StreamHandler(sys.stdout)
    if json_logs:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"))
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    if otel_endpoint:
        set_exporter(OtlpHttpExporter(otel_endpoint))
        root.info("otel export enabled endpoint=%s", otel_endpoint)
    return root


def get_logger(name: str = "asr") -> logging.Logger:
    return logging.getLogger(name)


@contextlib.contextmanager
def request_span(kind: str, request_id: Optional[str] = None,
                 **fields: Any) -> Iterator[Dict[str, Any]]:
    """Attach request-scoped fields to all logs inside the span and emit
    start/end events with duration (span helpers,
    ref: tracing_config.rs:178-233)."""
    ctx = dict(_request_ctx.get())
    span = {"request_id": request_id or uuid.uuid4().hex[:16],
            "span": kind, **fields}
    token = _request_ctx.set({**ctx, **span})
    log = get_logger()
    t0 = time.perf_counter()
    start_ns = time.time_ns()
    log.debug("span start", extra={"fields": {"event": "start"}})
    try:
        yield span
        log.info("span end", extra={"fields": {
            "event": "end", "duration_ms":
                round((time.perf_counter() - t0) * 1e3, 2)}})
        if _exporter is not None:
            _exporter.export_span(kind, start_ns, time.time_ns(), span,
                                  ok=True)
    except Exception as e:
        log.error("span error: %s", e, extra={"fields": {
            "event": "error", "duration_ms":
                round((time.perf_counter() - t0) * 1e3, 2)}})
        if _exporter is not None:
            _exporter.export_span(kind, start_ns, time.time_ns(),
                                  {**span, "error": str(e)}, ok=False)
        raise
    finally:
        _request_ctx.reset(token)
