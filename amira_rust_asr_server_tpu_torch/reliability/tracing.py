"""Structured logging, the span recorder, and OTLP export.

Parity role of the reference's tracing stack (ref:
src/reliability/tracing_config.rs:16-233): JSON structured logs, env-filter
style level control, request context fields, and a real OpenTelemetry span
exporter — OTLP/HTTP JSON encoded with the stdlib (no SDK in the image) —
that degrades gracefully when no collector is reachable (the reference's
Jaeger fallback behavior, tracing_config.rs:39-111).

The recorder is always on. Every finished span is one tuple ``(name,
span_id, parent_id, request_id, t0, t1, attrs)`` appended to a bounded
process-wide ring (:data:`RECORDER`, :data:`RING_SPANS` spans): ``t0`` and
``t1`` are ``time.monotonic()`` readings, ids come from one counter,
``request_id`` is the span id of the trace's root (a request's
``http.batch``, or a ``dispatch`` for the dispatch's own spans) and
``attrs`` is ``None`` or a tuple of ``(key, value)`` pairs. A span costs two
clock reads and one append, with no lock, log or formatting.
:func:`snapshot` copies the ring for a reader. With ``otel_endpoint`` set
(:func:`init_tracing`) every finished span is also handed to the
:class:`OtlpHttpExporter`, which encodes it on its own thread: one
``traceId`` per request, the real ``parentSpanId``, and for a dispatch a
link to each request in its lanes.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import os
import queue
import secrets
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

_request_ctx: contextvars.ContextVar[Dict[str, Any]] = \
    contextvars.ContextVar("asr_request_ctx", default={})

_exporter: Optional["OtlpHttpExporter"] = None

RING_SPANS = 1 << 17  # a 51 s window of batch serving at twice ~100 req/s

Record = Tuple[str, int, Optional[int], int, float, float,
               Optional[Tuple[Tuple[str, Any], ...]]]


class Snapshot(NamedTuple):
    """The ring's spans, and ``complete_from``: every span that ended at
    or after it is still held (``-inf`` until the ring first wraps; then
    the end of the newest span pushed out). A reader of the spans that
    start in a window needs ``complete_from`` below the window's start."""
    spans: List[Record]
    complete_from: float


class Span:
    """One span being recorded. :meth:`end`, or leaving its ``with`` block,
    records it; it may end on another thread than the one that began it."""

    __slots__ = ("_rec", "name", "id", "parent", "request_id", "attrs",
                 "t0", "t1")

    def __init__(self, rec: "Recorder", name: str,
                 parent: Optional["Span"], attrs):
        self._rec = rec
        self.name = name
        self.id = next(rec._ids)
        if parent is None:
            self.parent, self.request_id = None, self.id
        else:
            self.parent, self.request_id = parent.id, parent.request_id
        self.attrs = attrs
        self.t1: Optional[float] = None
        self.t0 = time.monotonic()

    def end(self) -> float:
        """Record the span (once; a later call changes nothing) and return
        its end."""
        if self.t1 is None:
            self.t1 = time.monotonic()
            self._rec._append((self.name, self.id, self.parent,
                               self.request_id, self.t0, self.t1,
                               self.attrs))
        return self.t1

    def set(self, key: str, value: Any) -> None:
        """Add one attribute before the span ends."""
        self.attrs = (*(self.attrs or ()), (key, value))

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Recorder:
    """The bounded ring of finished spans (appends are atomic under the
    interpreter lock, so threads record without a lock)."""

    def __init__(self, maxlen: int = RING_SPANS):
        self._ring: deque = deque(maxlen=maxlen)
        self._ids = itertools.count(1)
        self._complete_from = float("-inf")

    def begin(self, name: str, parent: Optional[Span] = None,
              attrs=None) -> Span:
        """A span starting now: a root when ``parent`` is None, else a
        child in the parent's trace. Use it in a ``with`` block, or call
        ``end()`` (from any thread) when the work ends."""
        return Span(self, name, parent, attrs)

    def _append(self, rec: Record) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            # unlocked: two threads appending at once may both read the same
            # oldest span, so this can trail by one span's microseconds
            self._complete_from = ring[0][5]
        ring.append(rec)
        if _exporter is not None:
            _exporter.export(rec)

    def snapshot(self) -> Snapshot:
        while True:
            try:
                return Snapshot(list(self._ring), self._complete_from)
            except RuntimeError:  # appended to while copied: copy again
                continue


RECORDER = Recorder()
span = RECORDER.begin  # a span of the process's ring: ``with`` it, or end()
snapshot = RECORDER.snapshot

_served = threading.local()


@contextlib.contextmanager
def serving(requests: Tuple[int, ...]) -> Iterator[None]:
    """Name the requests (their root span ids) whose lanes the calling
    thread's dispatches serve while the block runs: the batcher sets it
    around a device call, the pipeline's ``dispatch`` span reads it."""
    _served.requests = requests
    try:
        yield
    finally:
        _served.requests = ()


def served_requests() -> Tuple[int, ...]:
    return getattr(_served, "requests", ())


def current_request() -> Optional[int]:
    """The request id of the :func:`request_span` the caller runs in."""
    return _request_ctx.get().get("request_id")


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
        # the recorder's monotonic clock to Unix time, and this process's
        # half of every trace id (the other half is the request id)
        self._epoch_ns = time.time_ns() - time.monotonic_ns()
        self._trace_prefix = secrets.token_hex(8)
        self._queue: "queue.Queue[Record]" = queue.Queue(maxsize=max_queue)
        self._retry: list = []  # encoded spans a failed flush kept
        self._failures = 0
        self.disabled = False
        self.exported = 0  # spans delivered (observability/tests)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="otel-export",
                                        daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------
    def export(self, rec: Record) -> None:
        """Queue one recorded span; it is encoded on the export thread."""
        if self.disabled:
            return
        try:
            self._queue.put_nowait(rec)
        except queue.Full:
            pass  # shed under pressure; never block the request path

    # -- consumer side ------------------------------------------------------
    def _trace_id(self, request_id: int) -> str:
        return f"{self._trace_prefix}{request_id:016x}"

    def encode(self, rec: Record) -> dict:
        """One recorded span in the OTLP JSON form."""
        name, span_id, parent, request_id, t0, t1, attrs = rec
        attrs = dict(attrs or ())
        links = attrs.pop("requests", ())
        out = {
            "traceId": self._trace_id(request_id),
            "spanId": f"{span_id:016x}",
            "name": name,
            "kind": 2 if parent is None else 1,  # SERVER root, INTERNAL
            "startTimeUnixNano": str(self._epoch_ns + int(t0 * 1e9)),
            "endTimeUnixNano": str(self._epoch_ns + int(t1 * 1e9)),
            "attributes": [
                {"key": str(k), "value": _otlp_value(v)}
                for k, v in attrs.items() if v is not None],
            "status": {"code": 2 if "error" in attrs else 1},
        }
        if parent is not None:
            out["parentSpanId"] = f"{parent:016x}"
        if links:
            # a request's root span id is its request id
            out["links"] = [{"traceId": self._trace_id(r),
                             "spanId": f"{r:016x}"} for r in links]
        return out

    def _drain(self) -> list:
        spans = []
        while len(spans) < 512:
            try:
                spans.append(self.encode(self._queue.get_nowait()))
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
        spans, self._retry = self._retry + self._drain(), []
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
            # keep the batch for the next flush so a recovering collector
            # still gets it (and consecutive failures actually accumulate
            # toward the disable threshold); overflow is shed
            self._retry = spans[:self._queue.maxsize]

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
def request_span(kind: str, **fields: Any) -> Iterator[Span]:
    """The recorder's root span of one request, named ``kind``: its
    ``request_id`` (the root's span id) and ``fields`` go on every log line
    inside it, with start and end events and the duration (span helpers,
    ref: tracing_config.rs:178-233). Yields the root :class:`Span`, the
    parent of the request's other spans; an exception that escapes is the
    span's ``error``, and a cancellation (a client that went away) ends it
    with ``error`` ``cancelled``, so every recorded child has its root."""
    root = RECORDER.begin(kind, attrs=tuple(fields.items()) or None)
    token = _request_ctx.set({**_request_ctx.get(),
                              "request_id": root.request_id, "span": kind,
                              **fields})
    log = get_logger()
    log.debug("span start", extra={"fields": {"event": "start"}})
    error: Optional[str] = None
    try:
        yield root
    except Exception as e:
        error = str(e)
        raise
    except BaseException:
        error = "cancelled"
        raise
    finally:
        if error is not None:
            root.set("error", error)
        root.end()
        duration = {"duration_ms": round((root.t1 - root.t0) * 1e3, 2)}
        if error is None:
            log.info("span end", extra={"fields": {"event": "end",
                                                   **duration}})
        else:
            log.error("span error: %s", error, extra={"fields": {
                "event": "error", **duration}})
        _request_ctx.reset(token)
