"""The WebSocket streaming session (port of server/stream.py).

Protocol, as the reference's:
- binary frames carry 16-bit PCM; 1-byte frames are control bytes (END
  0xFF, KEEPALIVE 0x00);
- a 1 MB cap per frame and a 100 msg/s sliding-window rate limit;
- a partial once >= 0.1 s of audio is buffered (ACTIVE, with
  ``audio_length_seconds`` and ``processing_time_ms``), keepalive ticks
  every 100 ms, PAUSED frames after a KEEPALIVE, a 30 s inactivity timeout;
  the final response is COMPLETE;
- each decode runs within the inference budget (the cold-bucket budget
  while the program it runs is cold), with an ACTIVE "processing"
  heartbeat every keepalive period while it is awaited; a slow or shed
  partial is deferred, never the stream; the final drain retries a shed
  once; ``end_error_frame_parity`` sends the reference's Error frame
  before the final COMPLETE on END.

Modes: ``streaming_mode="chunked"`` (the default, and every non-causal
preset) runs :class:`~runtime.incremental.IncrementalAsr`, whose window
re-decodes ride the batcher's "stream" class; ``streaming_mode="native"``
on a causal preset attaches the stream to the shared lane engine, or to a
solo :class:`~runtime.native_stream.NativeStreamSession` when every lane is
busy (each chunk the pipeline's shared solo chunk program); with
``decoding_mode="beam"`` it runs a
:class:`~runtime.beam_stream.StreamingBeamSession` per stream (K
hypotheses carried across chunks, each chunk the pipeline's shared beam
chunk program).
"""

from __future__ import annotations

import asyncio
import collections
import threading
import time
import uuid
from typing import Optional

import numpy as np
from aiohttp import WSMsgType, web

from .. import constants as C
from ..audio import pcm16_bytes_to_f32
from ..errors import CapacityExceededError, CircuitOpenError
from ..reliability import get_logger
from ..runtime.beam_stream import StreamingBeamSession
from ..runtime.incremental import IncrementalAsr
from ..runtime.native_stream import NativeStreamSession
from ..types import AsrResponse, StreamStatus
from .state import AppState

log = get_logger("asr.stream")


class RateLimiter:
    """Sliding-window message rate limit."""

    def __init__(self, max_messages: int = C.MAX_MESSAGES_PER_WINDOW,
                 window_secs: float = C.RATE_LIMIT_WINDOW_SECS):
        self.max_messages = max_messages
        self.window_secs = window_secs
        self._count = 0
        self._window_start = time.monotonic()

    def check(self) -> bool:
        now = time.monotonic()
        if now - self._window_start >= self.window_secs:
            self._window_start = now
            self._count = 0
        self._count += 1
        return self._count <= self.max_messages


class _LaneAdapter:
    """One WebSocket session on the shared StreamingLaneEngine, or on a
    solo NativeStreamSession when every lane is busy. Engine access is
    serialized by ``state.lane_lock``; the lane ticker advances all ready
    lanes per tick, so concurrent streams batch."""

    def __init__(self, state: AppState):
        self.state = state
        self.engine = state.lane_engine
        self.lock = state.lane_lock
        self._samples = 0
        self.session: Optional[NativeStreamSession] = None
        with self.lock:
            self.lane = self.engine.attach()
        if self.lane is None:
            cfg = state.config
            self.session = NativeStreamSession(
                state.pipeline, chunk_frames=cfg.native_chunk_frames,
                norm=cfg.native_norm, max_symbols=cfg.max_symbols_per_step,
                max_total=cfg.max_total_tokens)

    @property
    def warmed(self) -> bool:
        """The program this stream runs is captured: the engine's chunk
        step, or the pipeline's solo chunk program."""
        if self.session is None:
            return self.engine.warmed_up
        s = self.session
        return self.state.pipeline.solo_chunk_warm(
            s.chunk_frames, s.max_symbols, s.max_total)

    def _feed(self, samples, final: bool) -> str:
        if self.session is not None:
            if final:
                return self.session.end().text
            return self.session.feed(samples)
        return self._feed_lane(samples, final)

    def _feed_lane(self, samples, final: bool) -> str:
        """Only the ticker steps the engine: a partial reads what it has
        decoded so far (append-only, at most one chunk behind); the final
        waits, bounded, for the lane's backlog to empty. A lane whose chunk
        step failed raises here."""
        with self.lock:
            self.engine.feed(self.lane, samples, final=final)
        deadline = (time.monotonic()
                    + self.state.config.inference_timeout_secs)
        while True:
            with self.lock:
                if not (final and self.engine.lane_ready(self.lane)):
                    return self.engine.transcript(self.lane)
            if time.monotonic() >= deadline:
                raise TimeoutError("the lane ticker did not drain the stream")
            time.sleep(0.005)

    def transcript(self) -> str:
        if self.session is not None:
            return self.session.transcript()
        with self.lock:
            return self.engine.transcript(self.lane)

    def process_chunk(self, audio_bytes: bytes) -> str:
        samples = pcm16_bytes_to_f32(audio_bytes)
        self._samples += samples.shape[0]
        return self._feed(samples, final=False)

    def finalize(self) -> str:
        text = self._feed(np.zeros(0, np.float32), final=True)
        self.release()
        return text

    def audio_length(self) -> float:
        return self._samples / C.SAMPLE_RATE

    def release(self) -> None:
        """Free the lane (also for streams that end without a drain)."""
        if self.lane is not None:
            with self.lock:
                self.engine.detach(self.lane)
            self.lane = None


class _BeamStreamAdapter:
    """One WebSocket session on its own StreamingBeamSession (beam mode on
    a causal preset, native streaming). Partials report the current best
    hypothesis, which may retract when the beam's leader changes (every
    partial carries the whole transcript, so the wire protocol represents
    a retraction). The session's device work runs under the pipeline's
    ``device_lock`` (:meth:`AsrPipeline.beam_chunk`)."""

    def __init__(self, state: AppState):
        cfg = state.config
        self.state = state
        self._samples = 0
        self.session = StreamingBeamSession(
            state.pipeline, chunk_frames=cfg.native_chunk_frames,
            norm=cfg.native_norm, beam_width=cfg.beam_width,
            graph=state.pipeline.beam_graph)

    @property
    def warmed(self) -> bool:
        """The chunk program this stream runs is captured."""
        return self.state.pipeline.beam_chunk_warm(
            self.session.chunk_frames, self.session.beam_width,
            self.session.max_expansions, self.session.graph)

    def process_chunk(self, audio_bytes: bytes) -> str:
        samples = pcm16_bytes_to_f32(audio_bytes)
        self._samples += samples.shape[0]
        return self.session.feed(samples)

    def transcript(self) -> str:
        return self.session.partial()

    def finalize(self) -> str:
        return self.session.end().text

    def audio_length(self) -> float:
        return self._samples / C.SAMPLE_RATE


class StreamProcessor:
    def __init__(self, ws: web.WebSocketResponse, state: AppState,
                 stream_id: Optional[str] = None):
        self.ws = ws
        self.state = state
        self.stream_id = stream_id or uuid.uuid4().hex
        cfg = state.config
        if (cfg.decoding_mode == "beam" and cfg.streaming_mode == "native"
                and state.pipeline.model.config.causal):
            # streaming beam: K hypotheses carried across chunks
            self.incremental = _BeamStreamAdapter(state)
        elif state.lane_engine is not None:
            # native mode on a causal preset: the shared lane engine
            self.incremental = _LaneAdapter(state)
        else:
            # chunked mode: window re-decodes go through the batcher, so
            # concurrent streams share device dispatches
            self.incremental = IncrementalAsr(
                state.pipeline, cfg.chunk_size_seconds,
                cfg.leading_context_seconds, cfg.trailing_context_seconds,
                cfg.buffer_capacity_seconds,
                decode_fn=state.batcher.submit_from_thread)
        # one stream's audio is decoded in arrival order: each partial's
        # work decodes, under the lock, the chunks queued when it got the
        # lock, so a timed-out or never-started work delays its audio to
        # the next work and never reorders or drops it
        self._work_lock = threading.Lock()
        self._queued: collections.deque = collections.deque()
        self.pending = bytearray()  # audio below the partial threshold
        self.last_transcription = ""
        self.is_paused = False
        self.rate_limiter = RateLimiter()
        self.closed = False

    # ------------------------------------------------------------------
    async def process(self) -> None:
        """Multiplex frames, keepalive ticks and shutdown."""
        cfg = self.state.config
        last_activity = time.monotonic()
        keepalive_period = cfg.keepalive_check_period_ms / 1000.0
        ended = False

        while not self.closed:
            if self.state.shutdown.is_shutting_down:
                log.info("stream %s: server shutdown", self.stream_id)
                break
            try:
                msg = await self.ws.receive(timeout=keepalive_period)
            except asyncio.TimeoutError:
                if (time.monotonic() - last_activity
                        > cfg.stream_timeout_secs):
                    await self.send_error("Stream timeout")
                    break
                if self.is_paused:
                    await self.send_response(AsrResponse(
                        transcription=self.last_transcription,
                        status=StreamStatus.PAUSED))
                continue

            if msg.type == WSMsgType.BINARY:
                last_activity = time.monotonic()
                try:
                    ended = await self.handle_audio_chunk(msg.data)
                except Exception as e:  # noqa: BLE001 — error frame + close
                    log.error("stream %s chunk error: %s",
                              self.stream_id, e)
                    self.state.metrics.record_error()
                    await self.send_error(str(e))
                    break
                if ended:
                    break
                # the client's silence counts from our answer: a decode
                # slower than the timeout is not the client's inactivity
                last_activity = time.monotonic()
            elif msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING,
                              WSMsgType.CLOSED, WSMsgType.ERROR):
                break
            # text, ping and pong frames are ignored

        if ended and cfg.end_error_frame_parity:
            # the reference routes END through its error path
            await self.send_error(
                "Server error: Request validation error: End of stream")

        if (self.pending or self._queued or ended
                or self.last_transcription):
            try:
                await self.process_buffered(is_final=True)
            except Exception as e:  # noqa: BLE001
                log.error("stream %s final drain failed: %s",
                          self.stream_id, e)
        if hasattr(self.incremental, "release"):
            self.incremental.release()  # free the engine lane

    # ------------------------------------------------------------------
    async def handle_audio_chunk(self, data: bytes) -> bool:
        """True when the END control byte arrived."""
        self.is_paused = False
        if self.state.prometheus:
            self.state.prometheus.websocket_messages.labels(
                direction="in").inc()
            self.state.prometheus.audio_chunk_bytes.observe(len(data))
        if len(data) > C.MAX_WS_CHUNK_BYTES:
            raise ValueError(
                f"Audio chunk too large: {len(data)} bytes "
                f"(max: {C.MAX_WS_CHUNK_BYTES})")
        if not self.rate_limiter.check():
            raise ValueError("Rate limit exceeded")
        if len(data) == 1:
            control = data[0]
            if control == C.CONTROL_BYTE_END:
                return True
            if control == C.CONTROL_BYTE_KEEPALIVE:
                self.is_paused = True
                return False
            raise ValueError("Unknown control byte")
        if len(data) % 2 != 0:
            raise ValueError(
                "Audio data length must be even for 16-bit PCM")
        self.pending += data
        if len(self.pending) >= C.MIN_PARTIAL_TRANSCRIPTION_SAMPLES * 2:
            await self.process_buffered(is_final=False)
        return False

    # ------------------------------------------------------------------
    async def process_buffered(self, is_final: bool) -> None:
        if self.pending:
            self._queued.append(bytes(self.pending))
            self.pending.clear()
        t0 = time.perf_counter()

        # a partial with nothing queued has nothing to decode; the final
        # always runs, after every earlier work, so it sees all the audio
        if self._queued or is_final:
            loop = asyncio.get_running_loop()
            finalize = getattr(self.incremental, "finalize", None)

            def work():
                with self._work_lock:
                    for _ in range(len(self._queued)):
                        self.incremental.process_chunk(self._queued.popleft())
                    if is_final and finalize is not None:
                        return finalize()
                    return self.incremental.transcript()
            # the budget follows the warmth of the program this stream
            # runs: a native or beam stream's chunk program, or (chunked)
            # the pipeline's buckets
            warmed = getattr(self.incremental, "warmed",
                             self.state.pipeline.warmed_up)
            budget = (self.state.config.inference_timeout_secs if warmed
                      else self.state.config.cold_bucket_timeout_secs)
            try:
                transcription = await self._decode_with_retry(
                    loop, work, budget, is_final)
            except (asyncio.TimeoutError, CircuitOpenError) as e:
                if is_final:
                    if isinstance(e, CircuitOpenError):
                        raise
                    raise ValueError("ASR processing timeout") from None
                # a slow partial (or an open breaker) defers this partial
                # only: the audio is buffered, the next window or the final
                # drain decodes it
                await self._defer_partial("slow decode")
                return
            except CapacityExceededError:
                # the admission queue was full for this window: shed one
                # partial, never the stream (the final drain already
                # retried once)
                if is_final:
                    raise
                await self._defer_partial("device busy")
                return
            self.last_transcription = transcription

        await self.send_response(AsrResponse(
            transcription=self.last_transcription,
            status=(StreamStatus.COMPLETE if is_final
                    else StreamStatus.ACTIVE),
            metadata={
                "audio_length_seconds": self.incremental.audio_length(),
                "processing_time_ms": round(
                    (time.perf_counter() - t0) * 1e3),
            }))

    async def _defer_partial(self, why: str) -> None:
        self.state.metrics.record_rejection()
        log.info("stream %s: partial deferred (%s)", self.stream_id, why)
        await self.send_response(AsrResponse(
            transcription=self.last_transcription,
            status=StreamStatus.ACTIVE, message="busy: partial deferred",
            metadata={"audio_length_seconds":
                      self.incremental.audio_length()}))

    # ------------------------------------------------------------------
    async def _decode_with_retry(self, loop, work, budget: float,
                                 is_final: bool):
        """Run the decode; the final drain retries once after a short
        backoff on a capacity shed (the client cannot re-send its audio),
        a partial sheds at once."""
        attempts = 2 if is_final else 1
        for attempt in range(attempts):
            fut = loop.run_in_executor(self.state.session_executor, work)
            waiting = self._await_with_heartbeat(fut, budget)
            try:
                return await self.state.breaker.call_async(waiting)
            except CapacityExceededError:
                if attempt + 1 >= attempts:
                    raise
                log.info("stream %s: final drain shed, retrying once",
                         self.stream_id)
                await asyncio.sleep(0.25)
            finally:
                waiting.close()  # never started when the breaker is open

    async def _await_with_heartbeat(self, fut, budget: float):
        """Await the decode, sending an ACTIVE "processing" frame with the
        last transcript every keepalive period while it runs, so a slow
        dispatch does not starve the client's receive loop."""
        period = max(self.state.config.keepalive_check_period_ms / 1000.0,
                     0.05)
        deadline = time.monotonic() + budget
        task = asyncio.ensure_future(fut)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                task.cancel()
                raise asyncio.TimeoutError
            try:
                return await asyncio.wait_for(
                    asyncio.shield(task), min(period, remaining))
            except asyncio.TimeoutError:
                if time.monotonic() - deadline >= 0:
                    task.cancel()
                    raise
                await self.send_response(AsrResponse(
                    transcription=self.last_transcription,
                    status=StreamStatus.ACTIVE, message="processing"))

    # ------------------------------------------------------------------
    async def send_response(self, response: AsrResponse) -> None:
        if self.ws.closed:
            self.closed = True
            return
        try:
            await self.ws.send_json(response.to_json())
            if self.state.prometheus:
                self.state.prometheus.websocket_messages.labels(
                    direction="out").inc()
        except ConnectionError:
            self.closed = True

    async def send_error(self, message: str) -> None:
        await self.send_response(AsrResponse(
            transcription="", status=StreamStatus.ERROR, message=message))
