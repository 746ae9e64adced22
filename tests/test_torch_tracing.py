"""PyTorch port: the span recorder (``reliability/tracing.py``) and the
spans and counters of the batch path, on the CPU with the tiny preset.

- the ring is bounded and says from when it holds every span;
- spans end once, also on another thread than the one that began them,
  and threads record at once without losing a span;
- one batch request leaves ``http.batch`` with ``http.read``,
  ``http.decode``, ``http.wait`` and ``http.respond`` as its children, and
  its JSON log line carries the same request id;
- the ``dispatch`` span names that request and holds ``dispatch.lock``,
  ``dispatch.stage``, ``dispatch.run`` and ``dispatch.readback``, and
  ``dispatch.capture`` when it makes its bucket's program;
- invalid JSON still answers 400, and its root span records the error;
- a cancelled request (its client went away) still records its root;
- the batcher's ``queued_total``, ``queue_wait_s_total`` and
  ``tokens_total`` move;
- OTLP export to a local collector: one trace id per request, the real
  parent ids, the dispatch's link to the request; an unreachable collector
  still disables the exporter.
"""

import asyncio
import io
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.reliability import tracing
from amira_rust_asr_server_tpu_torch.reliability.tracing import (
    JsonFormatter, OtlpHttpExporter, Recorder, set_exporter)
from amira_rust_asr_server_tpu_torch.server import (AppState, build_state,
                                                    create_app)
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits)
from amira_rust_asr_server_tpu_torch.utils import platform

torch.set_num_threads(2)
HTTP_CHILDREN = {"http.read", "http.decode", "http.wait", "http.respond"}
DISPATCH_CHILDREN = {"dispatch.lock", "dispatch.stage", "dispatch.run",
                     "dispatch.readback"}


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


@pytest.fixture(scope="module")
def pipeline():
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2, 4],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="cpu")
    state = build_state(cfg, preset="tiny", warmup=False)
    yield state.pipeline
    state.close()


@pytest.fixture
def state(pipeline):
    """A fresh AppState per test (its asyncio objects bind to one event
    loop) over the shared pipeline."""
    st = AppState(pipeline, pipeline.vocab)
    yield st
    st.close()


def _posts(state, *bodies, raw: bool = False) -> list:
    """(status, JSON answer) of batch POSTs sent one after another."""
    async def go():
        out = []
        async with TestClient(TestServer(create_app(state))) as client:
            for body in bodies:
                kw = {"data": body} if raw else {"json": body}
                resp = await client.post("/v2/decode/batch/default", **kw)
                out.append((resp.status, await resp.json()))
        return out
    return asyncio.run(go())


def _post(state, body, raw: bool = False):
    return _posts(state, body, raw=raw)[0]


def _spans_since(t: float) -> list:
    return [s for s in tracing.snapshot().spans if s[4] >= t]


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def test_ring_is_bounded_and_says_when_it_wrapped():
    rec = Recorder(maxlen=4)
    ends = {}
    for name in "abc":
        with rec.begin(name) as sp:
            pass
        ends[name] = sp.t1
    snap = rec.snapshot()
    assert [s[0] for s in snap.spans] == ["a", "b", "c"]
    assert snap.complete_from == float("-inf")
    for name in "defg":
        with rec.begin(name) as sp:
            pass
        ends[name] = sp.t1
    snap = rec.snapshot()
    assert [s[0] for s in snap.spans] == ["d", "e", "f", "g"]
    # "c" was the newest span pushed out: every span ending later is held
    assert snap.complete_from == ends["c"] < ends["d"]


def test_a_span_ends_once_and_may_end_on_another_thread():
    rec = Recorder(maxlen=16)
    root = rec.begin("root", attrs=(("k", 1),))
    child = rec.begin("child", root)
    t = threading.Thread(target=child.end)
    t.start()
    t.join(10)
    assert not t.is_alive()
    first = child.t1
    assert child.end() == first  # a second end records nothing
    root.set("more", "x")
    root.end()
    spans = rec.snapshot().spans
    assert [s[0] for s in spans] == ["child", "root"]
    c, r = spans
    assert c[2] == r[1] and c[3] == r[3] == r[1] and r[2] is None
    assert r[4] <= c[4] <= c[5] <= r[5]
    assert r[6] == (("k", 1), ("more", "x"))


def test_threads_record_at_once_without_losing_a_span():
    """More threads than cores record and end spans, and one copies the
    ring meanwhile, with a short switch interval: every span is held once,
    and every id is distinct."""
    rec = Recorder(maxlen=1 << 16)
    n_threads, per = 16, 500
    stop = threading.Event()
    copies = []

    def work():
        for _ in range(per):
            with rec.begin("w") as sp:
                rec.begin("c", sp).end()

    def copy():
        while not stop.is_set():
            copies.append(len(rec.snapshot().spans))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=copy)
        reader.start()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stop.set()
        reader.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not reader.is_alive()
    spans = rec.snapshot().spans
    assert len(spans) == 2 * n_threads * per
    assert len({s[1] for s in spans}) == len(spans)
    assert copies and max(copies) <= len(spans)


def test_batch_request_spans_share_the_request_id_with_its_log(state):
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(JsonFormatter())
    log = logging.getLogger("asr")
    old_level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    t = time.monotonic()
    try:
        status, body = _post(state, {"audio_buffer": list(
            pcm16_digits(["seven", "one"]))})
    finally:
        log.removeHandler(handler)
        log.setLevel(old_level)
    assert status == 200 and body["transcription"] == "seven one"
    spans = _spans_since(t)
    root = next(s for s in spans if s[0] == "http.batch")
    rid = root[1]
    assert root[2] is None and root[3] == rid
    assert dict(root[6])["bytes"] > 2 * len(pcm16_digits(["seven", "one"]))
    kids = [s for s in spans if s[2] == rid]
    assert {s[0] for s in kids} == HTTP_CHILDREN
    assert len(kids) == len(HTTP_CHILDREN)
    for s in kids:
        assert s[3] == rid
        assert root[4] <= s[4] <= s[5] <= root[5]
    order = sorted(kids, key=lambda s: s[4])
    assert [s[0] for s in order] == ["http.read", "http.decode", "http.wait",
                                     "http.respond"]
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    end = next(x for x in lines if x.get("span") == "http.batch"
               and x.get("event") == "end")
    assert end["request_id"] == rid


def _dispatches(state, *utterances) -> tuple:
    """One POST per utterance, one after another: (the dispatch span that
    served each, every span since the first began)."""
    t = time.monotonic()
    answers = _posts(state, *({"audio_buffer": list(pcm16_digits(words))}
                              for words in utterances))
    assert [status for status, _ in answers] == [200] * len(utterances)
    spans = _spans_since(t)
    names = _by_name(spans)
    roots = sorted(names["http.batch"], key=lambda s: s[4])
    tops = [next(s for s in names["dispatch"]
                 if root[1] in dict(s[6])["requests"]) for root in roots]
    return tops, spans


def _children(spans, top) -> dict:
    return {s[0]: s for s in spans if s[2] == top[1]}


def test_dispatch_span_names_the_request_and_holds_its_phases(state):
    # the first of two dispatches in a bucket may make its program
    (_, top), spans = _dispatches(state, ["five"], ["two"])
    attrs = dict(top[6])
    assert attrs["lanes"] == 1 and attrs["batch"] == 1
    assert attrs["length"] == 32000
    kids = _children(spans, top)
    assert set(kids) == DISPATCH_CHILDREN  # the bucket's program is made
    for s in kids.values():
        assert s[3] == top[1]
        assert top[4] <= s[4] <= s[5] <= top[5]
    order = sorted(kids, key=lambda n: kids[n][4])
    assert order == ["dispatch.lock", "dispatch.stage", "dispatch.run",
                     "dispatch.readback"]
    # the dispatch runs inside its request's wait, after the hand-off
    rid = dict(top[6])["requests"][0]
    (wait,) = [s for s in spans if s[0] == "http.wait" and s[2] == rid]
    assert wait[4] <= top[4] <= top[5] <= wait[5]
    names = _by_name(spans)
    for name in ("batcher.window", "batcher.handoff", "batcher.fanout"):
        assert any(wait[4] <= s[4] <= wait[5] for s in names[name]), name


def test_a_bucket_made_inside_a_dispatch_is_a_capture_span(pipeline):
    """A pipeline with no programs yet: its first dispatch makes the
    bucket's program inside ``dispatch.capture``."""
    pipeline.programs.clear()
    st = AppState(pipeline, pipeline.vocab)
    try:
        (top,), spans = _dispatches(st, ["six"])
    finally:
        st.close()
    kids = _children(spans, top)
    assert set(kids) == DISPATCH_CHILDREN | {"dispatch.capture"}
    made = kids["dispatch.capture"]
    assert kids["dispatch.lock"][5] <= made[4] <= made[5] <= \
        kids["dispatch.stage"][4]


def test_invalid_json_answers_400_and_records_the_error(state):
    t = time.monotonic()
    status, body = _post(state, b"{not json", raw=True)
    assert status == 400
    assert body["error"] == "request_validation"
    spans = _spans_since(t)
    root = next(s for s in spans if s[0] == "http.batch")
    assert dict(root[6])["error"] == "RequestValidationError"
    assert {s[0] for s in spans if s[2] == root[1]} == {"http.read",
                                                        "http.decode"}


def test_a_cancelled_request_still_records_its_root():
    """A client that goes away cancels the handler inside the request's
    span: the root ends with the error ``cancelled`` and its log line is
    written, so the child it recorded has its root."""
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(JsonFormatter())
    log = logging.getLogger("asr")
    old_level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)

    async def handle(ready):
        with tracing.request_span("http.batch") as root:
            tracing.span("http.read", root).end()
            ready.set()
            await asyncio.sleep(60)

    async def go():
        ready = asyncio.Event()
        task = asyncio.create_task(handle(ready))
        await ready.wait()
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    t = time.monotonic()
    try:
        asyncio.run(go())
    finally:
        log.removeHandler(handler)
        log.setLevel(old_level)
    spans = _spans_since(t)
    (root,) = [s for s in spans if s[0] == "http.batch"]
    assert dict(root[6])["error"] == "cancelled"
    (read,) = [s for s in spans if s[0] == "http.read"]
    assert read[2] == read[3] == root[1]
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    (err,) = [x for x in lines if x.get("event") == "error"]
    assert err["request_id"] == root[1] and err["span"] == "http.batch"
    assert tracing.current_request() is None


def test_batcher_counts_queue_wait_and_tokens(state):
    before = state.batcher.stats.to_json()
    status, body = _post(state, {"audio_buffer": list(
        pcm16_digits(["three", "nine"]))})
    assert status == 200
    after = state.batcher.stats.to_json()
    assert after["queued_total"] - before["queued_total"] == 1
    assert after["queue_wait_s_total"] > before["queue_wait_s_total"]
    assert after["tokens_total"] - before["tokens_total"] == \
        len(body["metadata"]["tokens"]) == 2
    assert after["lanes_total"] - before["lanes_total"] == 1


class _Collector(BaseHTTPRequestHandler):
    received = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        _Collector.received.append(json.loads(body))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):  # quiet
        pass


@pytest.fixture
def collector():
    _Collector.received = []
    server = HTTPServer(("127.0.0.1", 0), _Collector)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    thread.join(10)


def _wait(pred, timeout=15.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_otlp_spans_of_a_request_share_one_trace(state, collector):
    exp = OtlpHttpExporter(collector, flush_interval_s=0.1)
    set_exporter(exp)
    try:
        status, _ = _post(state, {"audio_buffer": list(
            pcm16_digits(["four"]))})
        assert status == 200

        def spans():
            return [s for b in _Collector.received
                    for rs in b["resourceSpans"]
                    for ss in rs["scopeSpans"] for s in ss["spans"]]
        assert _wait(lambda: {"http.batch", "dispatch", "dispatch.readback"}
                     <= {s["name"] for s in spans()})
    finally:
        set_exporter(None)
    got = spans()
    root = next(s for s in got if s["name"] == "http.batch")
    trace = [s for s in got if s["traceId"] == root["traceId"]]
    assert {s["name"] for s in trace} == {"http.batch", "http.decode.native"
                                          } | HTTP_CHILDREN
    assert "parentSpanId" not in root and root["kind"] == 2
    decode = next(s for s in trace if s["name"] == "http.decode")
    for s in trace:
        if s["name"] == "http.decode.native":  # on the body pool's thread
            assert s["parentSpanId"] == decode["spanId"]
        elif s is not root:
            assert s["parentSpanId"] == root["spanId"]
        assert int(s["startTimeUnixNano"]) <= int(s["endTimeUnixNano"])
    # about now on the wall clock, not on the monotonic one
    assert abs(int(root["endTimeUnixNano"]) / 1e9 - time.time()) < 60
    top = next(s for s in got if s["name"] == "dispatch"
               and s.get("links"))
    assert top["links"] == [{"traceId": root["traceId"],
                             "spanId": root["spanId"]}]
    assert top["traceId"] != root["traceId"]
    stage = next(s for s in got if s["name"] == "dispatch.stage"
                 and s["traceId"] == top["traceId"])
    assert stage["parentSpanId"] == top["spanId"]
    # other requests get other traces
    assert len({s["traceId"] for s in got if s["name"] == "http.batch"}) == \
        sum(s["name"] == "http.batch" for s in got)


def test_unreachable_collector_disables_the_exporter():
    exp = OtlpHttpExporter("http://127.0.0.1:1", flush_interval_s=0.05,
                           max_failures=2, timeout_s=0.2)
    rec = Recorder(maxlen=8)
    for i in range(4):
        rec.begin(f"s{i}").end()
        exp.export(rec.snapshot().spans[-1])
    assert _wait(lambda: exp.disabled)
    exp.export(rec.snapshot().spans[0])  # a disabled exporter sheds
    assert exp.exported == 0
    exp.shutdown()
